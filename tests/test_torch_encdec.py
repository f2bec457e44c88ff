"""The port's encoder-decoder and patch-frontend LMs (on the CPU) against the JAX package.

``reduced(seamless-m4t-medium)`` (2 encoder and 2 decoder layers, the
``frame`` frontend's ``src_embeds``) and ``reduced(internvl2-76b)`` (8
``patch_embeds`` before the text) with the JAX package's parameters
carried across by ``interop.lm_params_from_numpy``: prefill logits and
self K/V caches, three decode steps, ``encode``, the greedy tokens of
``launch.serve.serve`` against a JAX loop, the parameter round trip and
the exact counts.

The JAX package's prefill never writes an encoder-decoder's cross K/V
(``src/repro/models/lm.py:222,286-302``: the cross-attention runs without
a cache), so its decode stops cross-attending after the first token.  The
port writes them at prefill; its decode is held against JAX's decode
branch fed a cache whose ``xk``/``xv`` this file fills from ``lm.encode``'s
output projected by each layer's ``xattn.wk``/``wv``, after showing that
the unfilled cache (the reference's behaviour) moves the logits past the
tolerance.

Tolerances, as in ``test_torch_lm.py``: float32 elementwise at
``atol = rtol = 1e-4``; bf16 at a relative L2 error of ``2e-2``.  The
parameter round trip and the counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.sharding import Axes
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_REL_L2 = 2e-2
SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-76b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _gap(got, want, tol) -> float:
    """The error ``tol`` measures: the largest |got - want| beyond
    ``atol + rtol |want|`` (``tol`` a dict; 0 when within), or the relative
    L2 error (``tol`` a float)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if isinstance(tol, dict):
        return float(np.max(np.abs(got - want) - tol["atol"] - tol["rtol"] * np.abs(want),
                            initial=0.0))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, tol, what):
    if isinstance(tol, dict):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=what)
        return
    err = _gap(got, want, tol)
    assert err <= tol, f"{what}: relative L2 error {err:.3g} > {tol}"


def _far(got, want, tol) -> bool:
    """``got`` is outside the tolerance of ``want``."""
    return _gap(got, want, tol) > (0.0 if isinstance(tol, dict) else tol)


def _models(arch, seed, **over):
    """(JAX cfg, port cfg, JAX params, the same params in the port)."""
    cfg_j = jcfg.reduced(jcfg.get_config(arch), **over)
    cfg_t = tcfg.reduced(tcfg.get_config(arch), **over)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, params_j, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t,
                                                                "cpu")


def _embeds(cfg, b: int, rng) -> dict:
    """The frontend's float32 input for ``b`` rows: ``patch_embeds`` of
    ``frontend_len`` patches or 12 frames of ``src_embeds``."""
    if cfg.frontend == "patch":
        return {"patch_embeds": rng.standard_normal((b, cfg.frontend_len, cfg.d_model),
                                                    dtype=np.float32)}
    return {"src_embeds": rng.standard_normal((b, 12, cfg.d_model), dtype=np.float32)}


def _cross_filled(params_j, cfg_j, cache_j, src, mesh, axes):
    """JAX's prefill cache with each decoder layer's ``xk``/``xv`` filled
    as its decode branch reads them: ``lm.encode``'s output through the
    layer's ``xattn.wk``/``wv``, (B, Hkv, S, hd)."""
    enc = jlm.encode(params_j, cfg_j, jnp.asarray(src), mesh, axes)
    b, s = enc.shape[:2]
    xattn = params_j["stack"]["p0"]["xattn"]

    def proj(w):     # w (units, D, Hkv*hd) -> (units, B, Hkv, S, hd)
        y = jnp.einsum("bsd,ude->ubse", enc, w)
        return y.reshape(w.shape[0], b, s, cfg_j.n_kv_heads, cfg_j.head_dim).transpose(
            0, 1, 3, 2, 4)
    stack = dict(cache_j["stack"])
    stack["p0"] = dict(stack["p0"], xk=proj(xattn["wk"]), xv=proj(xattn["wv"]))
    return dict(cache_j, stack=stack)


def _jax_steps(cfg_j, mesh, cache_len):
    axes = Axes.from_mesh(mesh)
    prefill = jax.jit(lambda p, bt: jlm.prefill(p, cfg_j, bt, cache_len=cache_len, mesh=mesh,
                                                axes=axes))
    step = jax.jit(lambda p, c, tt: jlm.decode_step(p, cfg_j, c, tt, mesh=mesh, axes=axes))
    return prefill, step


@pytest.mark.parametrize("arch,over,tol", [
    (SEAMLESS, {}, F32), (SEAMLESS, {"dtype": "bfloat16"}, BF16_REL_L2),
    (INTERNVL, {}, F32), (INTERNVL, {"dtype": "bfloat16"}, BF16_REL_L2)],
    ids=["seamless-f32", "seamless-bf16", "internvl-f32", "internvl-bf16"])
def test_prefill_and_decode_match_jax(mesh11, arch, over, tol):
    cfg_j, cfg_t, params_j, params_t = _models(arch, 1, **over)
    axes = Axes.from_mesh(mesh11)
    b, t, extra = 2, 16, 3
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_j.vocab, (b, t + extra), dtype=np.int32)
    emb = _embeds(cfg_t, b, rng)
    n_patch = cfg_t.frontend_len if "patch_embeds" in emb else 0
    cache_len = n_patch + t + extra + 1
    prefill_j, step_j = _jax_steps(cfg_j, mesh11, cache_len)

    batch_j = {"tokens": jnp.asarray(toks[:, :t]), **{k: jnp.asarray(e) for k, e in emb.items()}}
    batch_t = {"tokens": torch.from_numpy(toks[:, :t]),
               **{k: torch.from_numpy(e) for k, e in emb.items()}}
    cache_j, logits_j = prefill_j(params_j, batch_j)
    cache_t, logits_t = tlm.prefill(params_t, cfg_t, batch_t, cache_len=cache_len)
    v = cfg_t.vocab
    assert logits_t.dtype == tlm.dtype_of(cfg_t) and logits_t.shape == (b, cfg_t.padded_vocab)
    assert bool((logits_t[:, v:] == -1e30).all())
    _close(logits_t[:, :v], logits_j[:, :v], tol, "prefill logits")
    assert cache_t["pos"] == int(cache_j["pos"]) == n_patch + t
    layers_j = interop.lm_params_from_numpy(_np_tree(cache_j), cfg_t, "cpu")["layers"]
    for i, (lt, lj) in enumerate(zip(cache_t["layers"], layers_j)):
        for name in ("k", "v"):
            _close(lt[name], lj[name], tol, f"layer {i} cache {name}")

    if cfg_t.encoder_layers:
        # the reference fault: JAX's prefill cache holds no cross K/V
        assert all(set(c) == {"k", "v"} for c in cache_j["stack"].values())
        cache_jx = _cross_filled(params_j, cfg_j, cache_j, emb["src_embeds"], mesh11, axes)
        for i, lt in enumerate(cache_t["layers"]):
            for name in ("xk", "xv"):
                assert lt[name].shape == (b, cfg_t.n_kv_heads, 12, cfg_t.head_dim)
                _close(lt[name], cache_jx["stack"]["p0"][name][i], tol,
                       f"layer {i} cross cache {name}")
        tt = toks[:, t:t + 1]
        unfilled, _ = step_j(params_j, cache_j, jnp.asarray(tt))
        filled, _ = step_j(params_j, cache_jx, jnp.asarray(tt))
        # (decode writes slot t of cache_t's buffers; the loop's first step rewrites it)
        port, _ = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt))
        # the check below would catch a port that drops the cross-attention
        assert _far(unfilled[:, :v], filled[:, :v], tol)
        assert _far(port[:, :v], unfilled[:, :v], tol)
        cache_j = cache_jx

    for n in range(extra):
        tt = toks[:, t + n:t + n + 1]
        logits_j, cache_j = step_j(params_j, cache_j, jnp.asarray(tt))
        logits_t, cache_t = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt))
        _close(logits_t[:, :v], logits_j[:, :v], tol, f"decode step {n} logits")
    assert cache_t["pos"] == int(cache_j["pos"]) == n_patch + t + extra


def test_encode_matches_jax(mesh11):
    """``encode`` at 40 source frames, not a multiple of JAX's key block (16)."""
    cfg_j, cfg_t, params_j, params_t = _models(SEAMLESS, 2, attn_k_block=16)
    src = np.random.default_rng(7).standard_normal((2, 40, cfg_t.d_model), dtype=np.float32)
    want = jax.jit(lambda p, s: jlm.encode(p, cfg_j, s, mesh11, Axes.from_mesh(mesh11)))(
        params_j, jnp.asarray(src))
    got = tlm.encode(params_t, cfg_t, torch.from_numpy(src))
    _close(got, want, F32, "encoder output")


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_serve_tokens_match_jax_loop(mesh11, arch):
    """``serve`` with each request's frontend embeddings gives the greedy
    tokens of a JAX loop built from the JAX step builders on the same
    parameters, prompts and embeddings (for seamless, each prefill's cache
    gets its cross K/V filled as the decode branch reads them); the last
    wave is padded."""
    cfg_j, cfg_t, params_j, params_t = _models(arch, 3)
    axes = Axes.from_mesh(mesh11)
    requests, batch, prompt_len, gen = 5, 2, 12, 4
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg_j.vocab, (requests, prompt_len), dtype=np.int32)
    emb = _embeds(cfg_t, requests, rng)
    (key, e), = emb.items()
    n_patch = e.shape[1] if key == "patch_embeds" else 0
    prefill = jax.jit(jsteps.make_prefill_step(cfg_j, mesh11,
                                               cache_len=n_patch + prompt_len + gen))
    decode = jax.jit(jsteps.make_serve_step(cfg_j, mesh11))
    want = {i: [] for i in range(requests)}
    for w0 in range(0, requests, batch):
        active = list(range(w0, min(w0 + batch, requests)))
        wave = np.zeros((batch, prompt_len), np.int32)
        wave[:len(active)] = prompts[active]
        wave_e = np.zeros((batch, *e.shape[1:]), np.float32)
        wave_e[:len(active)] = e[active]
        cache, logits = prefill(params_j, {"tokens": jnp.asarray(wave), key: jnp.asarray(wave_e)})
        if key == "src_embeds":
            cache = _cross_filled(params_j, cfg_j, cache, wave_e, mesh11, axes)
        tok = jnp.argmax(logits, axis=-1)[:, None]
        for _ in range(gen):
            for j, rid in enumerate(active):
                want[rid].append(int(tok[j, 0]))
            logits, cache = decode(params_j, cache, tok.astype(jnp.int32))
            tok = jnp.argmax(logits, axis=-1)[:, None]

    got = tserve.serve(params_t, cfg_t, torch.from_numpy(prompts), batch, gen,
                       **{key: torch.from_numpy(e)})
    assert got == want


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_params_round_trip(arch):
    """JAX pytree -> port -> JAX layout gives every leaf back (seamless's
    ``enc_stack`` and ``enc_norm``, each decoder layer's ``ln_x`` and
    ``xattn``)."""
    cfg_j, cfg_t, params_j, params_t = _models(arch, 4)
    assert len(params_t["layers"]) == cfg_t.n_layers
    assert len(params_t.get("encoder", [])) == cfg_t.encoder_layers
    assert all(("xattn" in bp) == bool(cfg_t.encoder_layers) for bp in params_t["layers"])
    back = interop.lm_params_to_numpy(params_t, cfg_t)
    want = _np_tree(params_j)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape, path
        assert np.array_equal(np.asarray(a, np.float32), b), path


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_counts_match_jax(arch, size):
    """Both exact counts equal JAX's; the port's seeded draw has as many."""
    cfg_j, cfg_t = jcfg.get_config(arch), tcfg.get_config(arch)
    if size == "reduced":
        cfg_j, cfg_t = jcfg.reduced(cfg_j), tcfg.reduced(cfg_t)
        params = tlm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
        assert sum(t.numel() for _, t in tlm._leaves(params)) == tlm.param_count_exact(cfg_t)
    assert tlm.param_count_exact(cfg_t) == jlm.param_count_exact(cfg_j)
    assert tlm.active_param_count_exact(cfg_t) == jlm.active_param_count_exact(cfg_j)


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_every_arch_supported(arch):
    """No architecture of the registry is refused, full or reduced."""
    for cfg in (tcfg.get_config(arch), tcfg.reduced(tcfg.get_config(arch))):
        tlm.check_supported(cfg)
        cache = tlm.cache_init(cfg, 1, 8, "meta", cross_len=4)
        kinds = [tlm.kind_at(cfg, i) for i in range(cfg.n_layers)]
        assert [("xk" in c) for c in cache["layers"]] == [
            bool(cfg.encoder_layers) and k != "a" for k in kinds]


def test_encdec_needs_source_and_cli():
    """An encoder-decoder prefill without ``src_embeds`` raises (JAX's fails
    at a reshape); the CLI serves tokens only: internvl's text without
    patches, and it refuses seamless."""
    cfg = tcfg.reduced(tcfg.get_config(SEAMLESS))
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="src_embeds"):
        tlm.prefill(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                    cache_len=6)
    assert tserve.main(["--arch", SEAMLESS, "--reduced", "--cpu"]) == 2
    assert tserve.main(["--arch", INTERNVL, "--reduced", "--cpu", "--requests", "2",
                        "--batch", "2", "--prompt-len", "6", "--gen", "3"]) == 0
