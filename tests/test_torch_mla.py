"""The port's MLA and the deepseek-v3 LM (on the CPU) against the JAX package.

``reduced(deepseek-v3-671b)``: two layers (one dense, one MoE with
sigmoid + bias routing and a shared expert), MLA with q_lora 32, kv_lora
16, nope 16, rope 8, v 16, the MTP head, float32.  One seeded draw of
the port's ``init_params`` in the JAX package's layout
(``interop.lm_params_to_numpy``, leaves in the dtypes of JAX's
``abstract_params``) is the JAX model's parameters, and is carried into
the port by ``interop.lm_params_from_numpy`` (JAX's eager ``init_params``
at this size takes ~11 s).  Inputs come from numpy with a seed.  Cases:

- ``mla_attention`` prefill, without and with a cache (the output and the
  cache written in place), and its three decode forms over several steps
  (``mla_absorb`` off: the whole cache expanded; on: latent-space
  attention; with ``mla_cp_decode``: the port's latent-space decode, which
  that flag selects on one rank, against JAX's context-parallel two-pass
  combine in ``shard_map`` over a 1 x 1 mesh), within
  ``ATTN_REL_L2`` relative L2 error (float32 sums in another order);
- ``probs_bf16``: ``flash_attention_plain`` against ``blockwise_attention``
  at a GQA shape, the padded-V MLA layer and a GQA layer, each with
  ``attn_probs_bf16``, within ``ATTN_REL_L2`` (both round the same
  probabilities to bf16: one key block in the JAX oracle at these sizes);
- the LM's prefill and three decode steps of logits against
  ``jlm.prefill``/``jlm.decode_step`` (float32 within ``LOGITS_REL_L2``;
  bf16 within ``BF16_LOGITS_REL_L2``, as ``test_torch_lm.py`` holds bf16);
- the parameters' round trip through ``interop``, bit for bit both ways,
  the MTP leaves included, in the tree of JAX's ``abstract_params``;
  ``serve.main --arch deepseek-v3-671b --reduced --cpu``;
- ``abstract_params``' exact and active counts equal to the JAX
  package's for every architecture the port initialises, full and reduced
  (the SSM ones, zamba2-7b and rwkv6-1.6b, too).

The card runs MLA prefill through the flash kernel (``chip_smoke.py``'s
deepseek cell and its float32 serve phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.mesh import make_test_mesh
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.sharding import Axes
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARCH = "deepseek-v3-671b"
ATTN_REL_L2 = 1e-5
LOGITS_REL_L2 = 1e-5
BF16_LOGITS_REL_L2 = 2e-2
B, T, STEPS = 2, 12, 3



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(**over):
    return (jcfg.reduced(jcfg.get_config(ARCH), **over),
            tcfg.reduced(tcfg.get_config(ARCH), **over))


def _models(seed, **over):
    """(JAX cfg, port cfg, JAX params, the same params in the port): one
    seeded draw of the port's init in JAX's layout and dtypes."""
    cfg_j, cfg_t = _cfgs(**over)
    drawn = interop.lm_params_to_numpy(
        tlm.init_params(cfg_t, torch.Generator().manual_seed(seed), "cpu"), cfg_t)
    params_j = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), drawn,
                                      jlm.abstract_params(cfg_j))
    return cfg_j, cfg_t, params_j, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t,
                                                                "cpu")


@pytest.fixture(scope="module")
def model():
    """The reduced float32 model in both packages, the first layer's
    attention parameters, and a numpy input."""
    cfg_j, cfg_t, params_j, params_t = _models(1)
    x = np.random.default_rng(2).standard_normal((B, T + STEPS, cfg_t.d_model)).astype(
        np.float32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j, params_t=params_t,
                attn_j=params_j["prefix_0"]["attn"], attn_t=params_t["layers"][0]["attn"], x=x)


def _positions(b, t0, t1):
    pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32)[None], (b, t1 - t0))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def _mla_cache_j(cfg, s):
    m = cfg.mla
    return {"c_kv": jnp.zeros((B, s, m.kv_lora_rank)),
            "k_rope": jnp.zeros((B, s, m.qk_rope_head_dim))}


@pytest.mark.parametrize("with_cache", [False, True], ids=["no_cache", "cache"])
def test_mla_prefill_matches_jax(model, with_cache):
    cfg_j, cfg_t, x = model["cfg_j"], model["cfg_t"], model["x"][:, :T]
    pj, pt = _positions(B, 0, T)
    s = T + 4
    cache_j = _mla_cache_j(cfg_j, s) if with_cache else None
    cache_t = tlm.cache_init(cfg_t, B, s, "cpu")["layers"][0] if with_cache else None
    out_j, new_j = jattn.mla_attention(model["attn_j"], jnp.asarray(x), cfg_j, positions=pj,
                                       cache=cache_j)
    out_t, new_t = tattn.mla_attention(model["attn_t"], torch.from_numpy(x), cfg_t,
                                       positions=pt, cache=cache_t)
    assert out_t.shape == (B, T, cfg_t.d_model)
    assert _rel(out_t, out_j) <= ATTN_REL_L2
    if with_cache:
        assert new_t["c_kv"] is cache_t["c_kv"]            # written in place
        for name in ("c_kv", "k_rope"):
            assert _rel(new_t[name], new_j[name]) <= ATTN_REL_L2, name
            assert not bool(new_t[name][:, T:].any()), name
    else:
        assert new_t is None and new_j is None


@pytest.mark.parametrize("form", ["expanded", "absorbed", "cp"])
def test_mla_decode_forms_match_jax(model, form):
    """Prefill T tokens, then decode STEPS tokens one at a time with the
    decode form's knobs; every step's output and the cache against JAX's."""
    over = {"expanded": {}, "absorbed": dict(mla_absorb=True),
            "cp": dict(mla_absorb=True, mla_cp_decode=True)}[form]
    cfg_j = dataclasses.replace(model["cfg_j"], **over)
    cfg_t = dataclasses.replace(model["cfg_t"], **over)
    mesh = make_test_mesh(1, 1) if form == "cp" else None
    axes = Axes.from_mesh(mesh) if mesh is not None else None
    x, s = model["x"], T + STEPS + 1
    pj, pt = _positions(B, 0, T)
    _, cache_j = jattn.mla_attention(model["attn_j"], jnp.asarray(x[:, :T]), cfg_j,
                                     positions=pj, cache=_mla_cache_j(cfg_j, s))
    cache_t = tlm.cache_init(cfg_t, B, s, "cpu")["layers"][0]
    tattn.mla_attention(model["attn_t"], torch.from_numpy(x[:, :T]), cfg_t, positions=pt,
                        cache=cache_t)
    step_j = jax.jit(lambda p, xx, c, pos, posv: jattn.mla_attention(
        p, xx, cfg_j, positions=posv, cache=c, cache_len=pos, mesh=mesh, axes=axes))
    errs = []
    for n in range(STEPS):
        pos = T + n
        pj, pt = _positions(B, pos, pos + 1)
        xs = x[:, pos:pos + 1]
        out_j, cache_j = step_j(model["attn_j"], jnp.asarray(xs), cache_j, pos, pj)
        out_t, cache_t = tattn.mla_attention(model["attn_t"], torch.from_numpy(xs), cfg_t,
                                             positions=pt, cache=cache_t, cache_len=pos)
        errs.append(_rel(out_t, out_j))
    assert max(errs) <= ATTN_REL_L2, errs
    for name in ("c_kv", "k_rope"):
        assert _rel(cache_t[name], cache_j[name]) <= ATTN_REL_L2, name


@pytest.mark.parametrize("case", ["gqa_plain", "mla_layer", "gqa_layer"])
def test_probs_bf16_matches_blockwise(model, case):
    """``probs_bf16``: the plain flash version (and the layers that pass
    ``cfg.attn_probs_bf16`` down) against ``blockwise_attention(probs_bf16=True)``."""
    rng = np.random.default_rng(3)
    if case == "gqa_plain":
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 4, 40, 24), (2, 2, 40, 24), (2, 2, 40, 24)))
        want = jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                         probs_bf16=True)
        got = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                        causal=True, probs_bf16=True)
        off = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
        assert _rel(off, want) > 10 * ATTN_REL_L2         # the flag changes the result
    elif case == "mla_layer":
        cfg_j = dataclasses.replace(model["cfg_j"], attn_probs_bf16=True)
        cfg_t = dataclasses.replace(model["cfg_t"], attn_probs_bf16=True)
        pj, pt = _positions(B, 0, T)
        x = model["x"][:, :T]
        want, _ = jattn.mla_attention(model["attn_j"], jnp.asarray(x), cfg_j, positions=pj)
        got, _ = tattn.mla_attention(model["attn_t"], torch.from_numpy(x), cfg_t, positions=pt)
        off, _ = tattn.mla_attention(model["attn_t"], torch.from_numpy(x), model["cfg_t"],
                                     positions=pt)
        assert _rel(off, want) > 10 * ATTN_REL_L2
    else:
        cfg_j = jcfg.reduced(jcfg.get_config("qwen3-4b"), attn_probs_bf16=True)
        cfg_t = tcfg.reduced(tcfg.get_config("qwen3-4b"), attn_probs_bf16=True)
        p_t = tattn.attn_init(torch.Generator().manual_seed(4), cfg_t, torch.float32, "cpu")
        p_j = {k: jnp.asarray(v.numpy()) for k, v in p_t.items()}
        x = rng.standard_normal((B, T, cfg_t.d_model)).astype(np.float32)
        pj, pt = _positions(B, 0, T)
        want, _ = jattn.attention(p_j, jnp.asarray(x), cfg_j, positions=pj)
        got, _ = tattn.attention(p_t, torch.from_numpy(x), cfg_t, positions=pt)
    assert _rel(got, want) <= ATTN_REL_L2


@pytest.mark.parametrize("dtype,tol", [("float32", LOGITS_REL_L2),
                                       ("bfloat16", BF16_LOGITS_REL_L2)], ids=["f32", "bf16"])
def test_lm_prefill_and_decode_match_jax(model, dtype, tol):
    if dtype == "float32":
        cfg_j, cfg_t, params_j, params_t = (model[k] for k in ("cfg_j", "cfg_t", "params_j",
                                                              "params_t"))
    else:
        cfg_j, cfg_t, params_j, params_t = _models(5, dtype=dtype)
    mesh = make_test_mesh(1, 1)
    axes = Axes.from_mesh(mesh)
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab, (B, T + STEPS), dtype=np.int32)
    prefill_j = jax.jit(lambda p, bt: jlm.prefill(p, cfg_j, bt, cache_len=T + STEPS,
                                                  mesh=mesh, axes=axes))
    step_j = jax.jit(lambda p, c, tt: jlm.decode_step(p, cfg_j, c, tt, mesh=mesh, axes=axes))
    cache_j, logits_j = prefill_j(params_j, {"tokens": jnp.asarray(toks[:, :T])})
    cache_t, logits_t = tlm.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks[:, :T])},
                                    cache_len=T + STEPS)
    v = cfg_t.vocab
    assert logits_t.shape == (B, cfg_t.padded_vocab) and bool((logits_t[:, v:] == -1e30).all())
    errs = [_rel(logits_t[:, :v], logits_j[:, :v])]
    for n in range(STEPS):
        tt = toks[:, T + n:T + n + 1]
        logits_j, cache_j = step_j(params_j, cache_j, jnp.asarray(tt))
        logits_t, cache_t = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt))
        errs.append(_rel(logits_t[:, :v], logits_j[:, :v]))
    assert max(errs) <= tol, errs
    assert cache_t["pos"] == int(cache_j["pos"]) == T + STEPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_with_mtp(dtype):
    """JAX pytree -> port -> JAX layout gives every leaf back bit for bit,
    and port -> JAX -> port every tensor: the MLA leaves of the prefix
    block and of the scanned stack, and the MTP head, in the tree, shapes
    and dtypes of JAX's ``abstract_params``."""
    cfg_j, cfg_t, params_j, params_t = _models(3, dtype=dtype)
    assert set(params_t) == {"embed", "final_norm", "lm_head", "layers", "mtp_block",
                             "mtp_norm", "mtp_proj"}
    assert set(params_t["layers"][1]["attn"]) == {"w_dq", "w_uq", "w_dkv", "w_kr", "w_ukv",
                                                  "wo"}
    shapes = jlm.abstract_params(cfg_j)
    want = _np_tree(params_j)
    back = interop.lm_params_to_numpy(params_t, cfg_t)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(shapes)
    for (path, a), b, s in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape == s.shape and a.dtype == s.dtype, path
        assert np.array_equal(np.asarray(a, np.float32), b), path
    # bf16 leaves come back as float32 arrays of the same values (numpy has no bf16)
    back_j = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), back, shapes)
    again = interop.lm_params_from_numpy(_np_tree(back_j), cfg_t, "cpu")
    for (path, a), (_, b) in zip(tlm._leaves(params_t), tlm._leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_serve_cli_deepseek(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--cpu", "--requests", "3",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 9 tokens in ")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-4b", "arctic-480b", ARCH, "zamba2-7b",
                                  "rwkv6-1.6b"])
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_counts_match_jax(arch, size):
    """``abstract_params`` allocates nothing; both exact counts equal JAX's."""
    cfg_j, cfg_t = jcfg.get_config(arch), tcfg.get_config(arch)
    if size == "reduced":
        cfg_j, cfg_t = jcfg.reduced(cfg_j), tcfg.reduced(cfg_t)
    shapes = tlm.abstract_params(cfg_t)
    assert all(t.is_meta for _, t in tlm._leaves(shapes))
    assert tlm.param_count_exact(cfg_t) == jlm.param_count_exact(cfg_j)
    assert tlm.active_param_count_exact(cfg_t) == jlm.active_param_count_exact(cfg_j)
