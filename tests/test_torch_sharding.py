"""The port's parameter layout over model ranks against the JAX package's rules.

``repro_torch.models.sharding`` keeps ``repro.models.sharding.param_spec``
by leaf name.  For every architecture at full size (the ``meta`` device)
each leaf's model-split dim is held against JAX's ``param_spec`` for the
same leaf in JAX's layout: the port's tree goes through
``interop.lm_params_to_numpy`` with each leaf replaced by its index, so a
scanned ``stack`` leaf names every layer it stacks.  The differences are
deliberate and listed: where JAX's rule cuts through a head, each rank
holds whole heads (``wk``/``wv`` where the kv heads are fewer than the
model ranks; Mamba2's ``in_proj`` and ``conv_w``, which keep every B/C
column on every rank, and its per-head leaves; RWKV-6's ``u`` and
``ln_x``).  At full width on the ``meta`` device each rank's shapes and
bytes are the hand-counted ones, and the ranks' Mamba2 columns rebuild the
whole leaf.  Then the ranks' sliced inits of reduced models concatenate to
the one-rank init bit for bit, every architecture splits where its dims
do, and what cannot split raises ``ValueError``.
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
from repro_torch.models import lm, moe, sharding, ssm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_MAMBA_HEADS = {"in_proj", "conv_w", "a_log", "dt_bias", "d_skip", "norm"}
#: (arch, model ranks) -> the leaves whose split differs from JAX's rule on
#: purpose (whole heads a rank; see ``models/sharding.py``)
DELIBERATE = {("gemma3-4b", 8): {"wk", "wv"},
              ("zamba2-7b", 4): _MAMBA_HEADS, ("zamba2-7b", 8): _MAMBA_HEADS,
              ("rwkv6-1.6b", 4): {"u", "ln_x"}, ("rwkv6-1.6b", 8): {"u", "ln_x"}}
#: the port's answer for each such leaf (0: split by rows, JAX replicates it)
WHOLE_HEADS = {"wk": sharding.KV_GROUP, "wv": sharding.KV_GROUP,
               "in_proj": sharding.MAMBA_IN, "conv_w": sharding.MAMBA_CONV}


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
                if got != want:
                    differ.setdefault(nm, set()).add(path[-1])
                    # JAX splits these columns contiguously or replicates the leaf
                    assert want == (1 if path[-1] in ("wk", "wv", "in_proj") else None), \
                        (arch, path, nm, got, want)
                    assert got == WHOLE_HEADS.get(path[-1], 0), (arch, path, nm, got)
    assert seen == set(range(len(leaves)))
    assert {(arch, nm): names for nm, names in differ.items()} == \
        {c: names for c, names in DELIBERATE.items() if c[0] == arch}


#: reduced zamba2-7b's Mamba2 at 8 heads (2 a rank at 4 ranks; the reduced
#: config has 2)
ZAMBA_SSM = dataclasses.replace(tcfg.reduced(tcfg.get_config("zamba2-7b")).ssm, n_heads=8)
SLICED = [("qwen3-4b", 2, {}), ("qwen3-4b", 4, {}), ("qwen3-4b", 4, dict(n_kv_heads=2)),
          ("arctic-480b", 2, {}), ("arctic-480b", 4, {}), ("deepseek-v3-671b", 2, {}),
          ("deepseek-v3-671b", 4, dict(mla_absorb=True, mla_cp_decode=True)),
          ("zamba2-7b", 2, {}), ("zamba2-7b", 4, dict(ssm=ZAMBA_SSM)),
          ("zamba2-7b", 4, dict(ssm=ZAMBA_SSM, n_kv_heads=2)), ("rwkv6-1.6b", 4, {}),
          ("seamless-m4t-medium", 4, {}), ("seamless-m4t-medium", 4, dict(n_kv_heads=2))]


def mamba_whole(parts: list, cfg, conv: bool) -> torch.Tensor:
    """Mamba2's ``in_proj`` (``[z | x | B | C | dt]``) or, with ``conv``,
    ``conv_w`` (``[x | B | C]``) rebuilt from the ranks' slices in rank
    order: each rank's heads' blocks concatenated, the B/C columns, which
    every rank holds whole, taken once (they must agree)."""
    inner, nh, _ = ssm.mamba_dims(cfg)
    nm, ds = len(parts), cfg.ssm.d_state
    il, hl = inner // nm, nh // nm
    blocks = ((il, 2 * ds) if conv else (il, il, 2 * ds, hl))
    split = [torch.split(p, blocks, dim=1) for p in parts]
    bc = len(blocks) - 1 if conv else 2
    assert all(torch.equal(sp[bc], split[0][bc]) for sp in split)
    return torch.cat([split[0][i] if i == bc else torch.cat([sp[i] for sp in split], dim=1)
                      for i in range(len(blocks))], dim=1)


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
        elif spec in (sharding.MAMBA_IN, sharding.MAMBA_CONV):
            assert torch.equal(mamba_whole(parts, cfg, spec == sharding.MAMBA_CONV), full), path
            n_split += 1
        else:
            assert torch.equal(torch.cat(parts, dim=spec), full), path
            n_split += 1
    assert n_split > 0


REFUSALS = {
    "mamba kinds": ("zamba2-7b", 4, {}, "Mamba2's n_heads = 2 does not split over 4"),
    "rwkv kinds": ("rwkv6-1.6b", 8, {}, "RWKV-6's heads = 4 does not split over 8"),
    "encoder-decoder": ("seamless-m4t-medium", 4, dict(n_heads=6, n_kv_heads=6),
                        "n_heads = 6"),
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


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_every_arch_splits_where_its_dims_do(arch):
    """No architecture of the registry is refused at (1, 4) or (2, 2): its
    parameters and cache at full width on the ``meta`` device."""
    cfg = tcfg.get_config(arch)
    for data, model in ((1, 4), (2, 2)):
        lay = sharding.Layout(data, model, 0, 0, Ranks(data), Ranks(model))
        sharding.check_layout(cfg, lay)
        lm.abstract_params(cfg, lay)
        lm.cache_init(cfg, 2, 8, "meta", cross_len=4, layout=lay)


def _bytes(shape, dtype=torch.bfloat16) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def _zamba2_rank(cfg, nm: int) -> dict:
    """zamba2-7b's leaves as one of ``nm`` model ranks holds them, counted by
    hand: Mamba2's heads and every B/C column; the shared block's heads,
    kv heads and d_ff; the vocab rows."""
    d, ds, dc, f = cfg.d_model, cfg.ssm.d_state, cfg.ssm.d_conv, cfg.d_ff
    inner, nh = 2 * d, 2 * d // 64
    il, hl, hd = inner // nm, nh // nm, cfg.head_dim
    q, kv = cfg.n_heads // nm * hd, cfg.n_kv_heads // nm * hd
    m = {"ln1": (d,), "in_proj": (d, 2 * il + 2 * ds + hl), "conv_w": (dc, il + 2 * ds),
         "a_log": (hl,), "dt_bias": (hl,), "d_skip": (hl,), "norm": (il,),
         "out_proj": (il, d)}
    shared = {"ln1": (d,), "ln2": (d,), "wq": (d, q), "wk": (d, kv), "wv": (d, kv),
              "wo": (q, d), "w_in": (d, f // nm), "w_gate": (d, f // nm), "w_out": (f // nm, d)}
    return {"embed": (cfg.padded_vocab // nm, d), "final_norm": (d,), "m": m,
            "a": {"ln1": (d,), "use_shared": ()}, "shared_attn": shared}


def _rwkv6_rank(cfg, nm: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    nh, hd = d // 64, 64
    dl = nh // nm * hd
    r = {"ln1": (d,), "ln2": (d,), "mu": (5, d), "wr": (d, dl), "wk": (d, dl), "wv": (d, dl),
         "wg": (d, dl), "ww": (d, d), "w0": (d,), "u": (nh // nm, hd), "wo": (dl, d),
         "ln_x": (dl,), "cmix_mu": (2, d), "w_in": (d, f // nm), "w_out": (f // nm, d)}
    return {"embed": (cfg.padded_vocab // nm, d), "lm_head": (cfg.padded_vocab // nm, d),
            "final_norm": (d,), "r": r}


def _seamless_rank(cfg, nm: int) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    q, kv = cfg.n_heads // nm * hd, cfg.n_kv_heads // nm * hd
    attn = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    block = {"ln1": (d,), "ln2": (d,), **attn, "w_in": (d, f // nm), "w_out": (f // nm, d)}
    return {"embed": (cfg.padded_vocab // nm, d), "lm_head": (cfg.padded_vocab // nm, d),
            "final_norm": (d,), "enc_norm": (d,), "encoder": block,
            "decoder": {**block, "ln_x": (d,), **{"x" + k: s for k, s in attn.items()}}}


_F32_LEAVES = {"a_log", "dt_bias", "d_skip", "use_shared", "w0", "u"}


def _hand_bytes(arch: str, cfg, nm: int) -> int:
    def tree(shapes: dict) -> int:
        return sum(_bytes(s, torch.float32 if k in _F32_LEAVES else torch.bfloat16)
                   for k, s in shapes.items())
    if arch == "zamba2-7b":
        h = _zamba2_rank(cfg, nm)
        kinds = [lm.kind_at(cfg, i) for i in range(cfg.n_layers)]
        return (tree({k: h[k] for k in ("embed", "final_norm")}) + tree(h["shared_attn"])
                + kinds.count("m") * tree(h["m"]) + kinds.count("a") * tree(h["a"]))
    if arch == "rwkv6-1.6b":
        h = _rwkv6_rank(cfg, nm)
        return (tree({k: h[k] for k in ("embed", "lm_head", "final_norm")})
                + cfg.n_layers * tree(h["r"]))
    h = _seamless_rank(cfg, nm)
    return (tree({k: h[k] for k in ("embed", "lm_head", "final_norm", "enc_norm")})
            + cfg.encoder_layers * tree(h["encoder"]) + cfg.n_layers * tree(h["decoder"]))


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "seamless-m4t-medium"])
def test_full_width_rank_shapes_and_bytes(arch):
    """At full width on the ``meta`` device each of 4 ranks holds the
    hand-counted shapes of the new kinds' leaves and the hand-counted bytes
    (0.25 of the split leaves, every replicated leaf whole)."""
    cfg = tcfg.get_config(arch)
    want = {"zamba2-7b": _zamba2_rank, "rwkv6-1.6b": _rwkv6_rank,
            "seamless-m4t-medium": _seamless_rank}[arch](cfg, 4)
    for r in range(4):
        got = dict(_leaves(lm.abstract_params(cfg, layout(4, r))))
        if arch == "zamba2-7b":
            first_a = cfg.layer_pattern.index("a")
            for name, shape in want["m"].items():
                key = ("layers", 0, name) if name == "ln1" else ("layers", 0, "mamba", name)
                assert tuple(got[key].shape) == shape, (r, key)
            for (blk, name), shape in [((b, n), s) for b in ("attn", "mlp")
                                       for n, s in want["shared_attn"].items()]:
                key = ("shared_attn", blk, name)
                if key in got:
                    assert tuple(got[key].shape) == shape, (r, key)
            assert tuple(got[("layers", first_a, "use_shared")].shape) == ()
        elif arch == "rwkv6-1.6b":
            for name, shape in want["r"].items():
                key = (("layers", 0, name) if name in ("ln1", "ln2") else
                       ("layers", 0, "cmix", "mu") if name == "cmix_mu" else
                       ("layers", 0, "cmix", name) if name in ("w_in", "w_out") else
                       ("layers", 0, "rwkv", name))
                assert tuple(got[key].shape) == shape, (r, key)
        else:
            for name, shape in want["decoder"].items():
                sub = ("xattn", name[1:]) if name in ("xwq", "xwk", "xwv", "xwo") else \
                    ("attn", name) if name in ("wq", "wk", "wv", "wo") else \
                    ("mlp", name) if name in ("w_in", "w_out") else (name,)
                assert tuple(got[("layers", 0, *sub)].shape) == shape, (r, sub)
                if sub[0] != "xattn" and sub[0] != "ln_x":
                    assert tuple(got[("encoder", 0, *sub)].shape) == shape, (r, sub)
        assert tuple(got[("embed",)].shape) == want["embed"], r
        assert sum(t.numel() * t.element_size() for t in got.values()) == \
            _hand_bytes(arch, cfg, 4), r


def test_mamba_columns_rebuild_the_whole_leaf():
    """zamba2-7b at full width: the 4 ranks' ``in_proj``, ``conv_w`` and
    ``norm`` columns (a row of column indices stands for each leaf) rebuild
    the whole leaf, the B/C columns taken once; each rank holds its 28
    heads' z, x and dt columns beside all 128 B/C columns."""
    cfg = tcfg.get_config("zamba2-7b")
    inner, nh, _ = ssm.mamba_dims(cfg)
    ds = cfg.ssm.d_state
    for name, width, spec in (("in_proj", 2 * inner + 2 * ds + nh, sharding.MAMBA_IN),
                              ("conv_w", inner + 2 * ds, sharding.MAMBA_CONV),
                              ("norm", inner, 0)):
        whole = torch.arange(width)[None] if spec != 0 else torch.arange(width)
        path = ("layers", 0, "mamba", name)
        assert sharding.param_spec(cfg, path, whole.dim(), 4) == spec
        parts = [sharding.rank_slice(whole, spec, cfg, layout(4, r), path) for r in range(4)]
        if spec == 0:
            assert torch.equal(torch.cat(parts), whole)
            continue
        assert all(p.shape[1] == (2 * 1792 + 2 * ds + 28 if name == "in_proj" else 1792 + 2 * ds)
                   for p in parts), [p.shape for p in parts]
        assert torch.equal(mamba_whole(parts, cfg, name == "conv_w"), whole)
