"""The port's parameter layout over model ranks against the JAX package's rules.

``repro_torch.models.sharding`` keeps ``repro.models.sharding.param_spec``
by leaf name.  For every architecture at full size (the ``meta`` device)
each leaf's model-split dim is held against JAX's ``param_spec`` for the
same leaf in JAX's layout: the port's tree goes through
``interop.lm_params_to_numpy`` with each leaf replaced by its index, so a
scanned ``stack`` leaf names every layer it stacks.  The one difference is
deliberate and listed: ``wk``/``wv`` where the kv heads are fewer than
the model ranks (each rank holds its query group's heads whole).  Then
the ranks' sliced inits of reduced models concatenate to the one-rank
init bit for bit, and what cannot split raises ``ValueError``.
"""

import dataclasses

import jax
import pytest
import torch

from repro import configs as jcfg
from repro.models import sharding as jsharding
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.core.backend import SerialBackend
from repro_torch.models import lm, moe, sharding
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

#: (arch, model ranks) whose wk/wv differ from JAX's rule on purpose
KV_GROUP_CASES = {("gemma3-4b", 8)}


class Ranks(SerialBackend):
    """A stand-in model axis of ``n`` ranks: slicing and the refusals read
    its size alone, and no collective runs."""

    def __init__(self, n: int):
        self.n = n

    def nprocs(self) -> int:
        return self.n


def layout(model: int, rank: int = 0) -> sharding.Layout:
    return sharding.Layout(1, model, 0, rank, SerialBackend(), Ranks(model))


def _indexed(tree, leaves, path=()):
    """``tree`` with each tensor replaced by its index in ``leaves`` (which
    gets its path and shape)."""
    if isinstance(tree, dict):
        return {k: _indexed(v, leaves, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_indexed(v, leaves, (*path, i)) for i, v in enumerate(tree)]
    leaves.append((path, tuple(tree.shape)))
    return torch.tensor(len(leaves) - 1)


def _jax_model_dim(spec, scanned: bool):
    dims = [i for i, a in enumerate(spec) if a == "model"]
    return None if not dims else dims[0] - (1 if scanned else 0)


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_param_spec_matches_jax(arch):
    cfg_t, cfg_j = tcfg.get_config(arch), jcfg.get_config(arch)
    leaves = []
    tree = interop.lm_params_to_numpy(_indexed(lm.abstract_params(cfg_t), leaves), cfg_t)
    axes = jsharding.Axes(data=("data",), model="model")
    seen, differ = set(), {}
    for kp, idx in jax.tree_util.tree_leaves_with_path(tree):
        key = jax.tree_util.keystr(kp)
        scanned = "stack" in key
        for i in idx.reshape(-1).tolist():
            path, shape = leaves[i]
            seen.add(i)
            want = _jax_model_dim(jsharding.param_spec(cfg_j, axes, key,
                                                       len(shape) + scanned, scanned),
                                  scanned)
            for nm in (4, 8):
                got = sharding.param_spec(cfg_t, path, len(shape), nm)
                if got == sharding.KV_GROUP:
                    differ.setdefault(nm, set()).add(path[-1])
                    assert want == 1, (arch, path)
                else:
                    assert got == want, (arch, key, path, nm, got, want)
    assert seen == set(range(len(leaves)))
    assert {(arch, nm) for nm in differ} == {c for c in KV_GROUP_CASES if c[0] == arch}
    assert all(names == {"wk", "wv"} for names in differ.values())


SLICED = [("qwen3-4b", 2, {}), ("qwen3-4b", 4, {}), ("qwen3-4b", 4, dict(n_kv_heads=2)),
          ("arctic-480b", 2, {}), ("arctic-480b", 4, {}), ("deepseek-v3-671b", 2, {}),
          ("deepseek-v3-671b", 4, dict(mla_absorb=True, mla_cp_decode=True))]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,nm,over", SLICED)
def test_sliced_init_is_the_one_rank_init(arch, nm, over):
    """Each rank draws the one-rank sequence and keeps its slice: the
    slices in rank order are the one-rank parameters bit for bit, each
    rank holds what ``shard_params`` cuts from the one-rank tree, and the
    shared leaves are whole on every rank."""
    cfg = tcfg.reduced(tcfg.get_config(arch), **over)
    gen = lambda: torch.Generator().manual_seed(5)          # noqa: E731
    one = lm.init_params(cfg, gen(), "cpu")
    whole = dict(_leaves(one))
    ranks = [dict(_leaves(lm.init_params(cfg, gen(), "cpu", layout(nm, r))))
             for r in range(nm)]
    for r, part in enumerate(ranks):
        cut = dict(_leaves(sharding.shard_params(one, cfg, layout(nm, r))))
        assert part.keys() == whole.keys() == cut.keys()
        assert all(torch.equal(part[p], cut[p]) for p in cut), r
    n_split = 0
    for path, full in whole.items():
        spec = sharding.param_spec(cfg, path, full.dim(), nm)
        parts = [rk[path] for rk in ranks]
        if spec is None:
            assert all(torch.equal(p, full) for p in parts), path
        elif spec == sharding.KV_GROUP:
            per = nm // cfg.n_kv_heads
            assert torch.equal(torch.cat(parts[::per], dim=1), full), path
            assert all(torch.equal(parts[r], parts[r - r % per]) for r in range(nm)), path
            n_split += 1
        else:
            assert torch.equal(torch.cat(parts, dim=spec), full), path
            n_split += 1
    assert n_split > 0


REFUSALS = {
    "mamba kinds": ("zamba2-7b", 2, {}, "6.2b"),
    "rwkv kinds": ("rwkv6-1.6b", 2, {}, "6.2b"),
    "encoder-decoder": ("seamless-m4t-medium", 2, {}, "encoder-decoder"),
    "heads": ("qwen3-4b", 4, dict(n_heads=6, n_kv_heads=2), "n_heads = 6"),
    "vocab": ("qwen3-4b", 3, dict(n_heads=6, n_kv_heads=3, d_ff=96), "padded_vocab = 512"),
    "d_ff": ("qwen3-4b", 4, dict(d_ff=130), "d_ff = 130"),
    "experts": ("arctic-480b", 4, {}, "n_experts = 6"),
    "kv heads": ("qwen3-4b", 4, dict(n_heads=12, n_kv_heads=3), "n_kv_heads = 3"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_unsplittable_layouts_raise(case):
    arch, nm, over, match = REFUSALS[case]
    cfg = tcfg.reduced(tcfg.get_config(arch), **over)
    if case == "experts":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=6))
    with pytest.raises(ValueError, match=match):
        lm.abstract_params(cfg, layout(nm))
    with pytest.raises(ValueError, match=match):
        lm.cache_init(cfg, 2, 8, "meta", layout=layout(nm))


def test_dispatch_and_cp_cache_that_do_not_split_raise():
    """MoE tokens that split over neither T nor B*T, and a context-parallel
    MLA cache whose length does not split over the model ranks."""
    assert moe.token_split(3, 4, 4) == "seq" and moe.token_split(4, 1, 4) == "rows"
    with pytest.raises(ValueError, match="each token must be dispatched once"):
        moe.token_split(3, 1, 4)
    cfg = tcfg.reduced(tcfg.get_config("deepseek-v3-671b"), mla_absorb=True,
                       mla_cp_decode=True)
    with pytest.raises(ValueError, match="context-parallel MLA cache of 11 positions"):
        lm.cache_init(cfg, 2, 11, "meta", layout=layout(4))
    c = lm.cache_init(cfg, 2, 12, "meta", layout=layout(4))["layers"][0]
    assert c["c_kv"].shape[1] == 3 and c["k_rope"].shape[1] == 3
