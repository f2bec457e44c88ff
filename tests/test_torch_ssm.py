"""The port's recurrent mixers and SSM LMs (on the CPU) against the JAX package.

Mamba2, RWKV-6's time mix and its channel mix (``repro_torch/models/ssm.py``)
against ``repro/models/ssm.py`` at reduced sizes, the port on its plain
scans: from no state, from a zero state (the serving form: Mamba's float32
conv state promotes a bf16 model's conv), then one decode step from the
returned state.  Float32 outputs and states elementwise at ``atol = rtol =
1e-5``; bf16 ones by relative L2 error at ``BF16_REL_L2`` (XLA's CPU bf16
path rounds at other places, as ``test_torch_lm.py`` states), with every
new state's dtype equal to JAX's.

``reduced(zamba2-7b, n_layers=9)`` (one ``mmmmma`` unit plus an ``mmm``
remainder: shared attention, the stacked ``use_shared`` marker) and
``reduced(rwkv6-1.6b)``: one seeded draw of the port's ``init_params`` in
JAX's layout and dtypes is the JAX model's parameters (JAX's eager
``init_params`` takes ~8 s at these sizes), carried into the port by
``interop.lm_params_from_numpy``: prefill logits and caches and three
decode steps at ``atol = rtol = 1e-4`` in float32 (the scans' sums and
the matmuls run in another order), one bf16 case (zamba2 at 3 layers) at
``BF16_REL_L2``;
``serve``'s greedy tokens against a JAX loop; the parameters' round trip;
``serve.main`` with ``--cpu``.  The JAX steps are jitted once per
architecture (module scope) and shared by the cases of one shape.

The card runs the scans' CUDA kernels (``chip_smoke.py``'s zamba2-7b and
rwkv6-1.6b cells and its float32 serve phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32_MIXER = dict(atol=1e-5, rtol=1e-5)
F32_LM = dict(atol=1e-4, rtol=1e-4)
BF16_REL_L2 = 2e-2
ARCHS = {"zamba2": ("zamba2-7b", dict(n_layers=9)), "rwkv6": ("rwkv6-1.6b", {})}
B, T, STEPS = 2, 12, 3



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    """Elementwise (``tol`` a dict) or by relative L2 error (``tol`` a float)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if isinstance(tol, dict):
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
        return
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= tol, f"{what}: relative L2 error {err:.3g} > {tol}"


def _jax(t: torch.Tensor):
    """A port tensor as a JAX array of the same dtype."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                       else t.numpy().dtype)


def _same_dtype(got: torch.Tensor, want, what):
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), \
        f"{what}: {got.dtype} vs {want.dtype}"


def _models(name, seed, **over):
    """(JAX cfg, port cfg, JAX params, the same params in the port)."""
    arch, base = ARCHS[name]
    over = {**base, **over}
    cfg_j = jcfg.reduced(jcfg.get_config(arch), **over)
    cfg_t = tcfg.reduced(tcfg.get_config(arch), **over)
    drawn = interop.lm_params_to_numpy(
        tlm.init_params(cfg_t, torch.Generator().manual_seed(seed), "cpu"), cfg_t)
    params_j = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), drawn,
                                      jlm.abstract_params(cfg_j))
    return cfg_j, cfg_t, params_j, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t,
                                                                "cpu")


# --------------------------------------------------------------------------
# the mixers
# --------------------------------------------------------------------------

def _mixer(mixer, dtype):
    """(port params, JAX apply (jitted: JAX's eager first calls take ~4x
    longer), port apply, JAX zero state, port zero state, port cfg) of one
    mixer at reduced size: ``apply(params, x, state) -> (y, state)``."""
    arch = "zamba2-7b" if mixer == "mamba" else "rwkv6-1.6b"
    cfg_j = jcfg.reduced(jcfg.get_config(arch), dtype=dtype)
    cfg_t = tcfg.reduced(tcfg.get_config(arch), dtype=dtype)
    tdt = tlm.dtype_of(cfg_t)
    gen = torch.Generator().manual_seed(7)
    if mixer == "mamba":
        p = tssm.mamba_init(gen, cfg_t, tdt, "cpu")
        return (p, jax.jit(lambda pp, x, st: jssm.mamba_apply(pp, x, cfg_j, st)),
                lambda pp, x, st: tssm.mamba_apply(pp, x, cfg_t, st),
                jssm.mamba_state_init(cfg_j, B), tssm.mamba_state_init(cfg_t, B, "cpu"), cfg_t)
    if mixer == "rwkv":
        p = tssm.rwkv_init(gen, cfg_t, tdt, "cpu")
        return (p, jax.jit(lambda pp, x, st: jssm.rwkv_apply(pp, x, cfg_j, st)),
                lambda pp, x, st: tssm.rwkv_apply(pp, x, cfg_t, st),
                jssm.rwkv_state_init(cfg_j, B), tssm.rwkv_state_init(cfg_t, B, "cpu", tdt),
                cfg_t)

    def j_cmix(pp, x, st):
        y, prev = jssm.rwkv_channel_mix(pp, x, None if st is None else st["prev"])
        return y, {"prev": prev}

    def t_cmix(pp, x, st):
        y, prev = tssm.rwkv_channel_mix(pp, x, None if st is None else st["prev"])
        return y, {"prev": prev}
    p = tssm.rwkv_channel_mix_init(gen, cfg_t, tdt, "cpu")
    return (p, jax.jit(j_cmix), t_cmix,
            {"prev": jnp.zeros((B, cfg_t.d_model), _jax(p["mu"]).dtype)},
            {"prev": torch.zeros((B, cfg_t.d_model), dtype=tdt)}, cfg_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mamba", "rwkv", "cmix"])
def test_mixer_matches_jax(mixer, dtype):
    """No state, a zero state, then one decode step from the returned
    state: outputs and states against JAX's, the states' dtypes equal
    (Mamba's conv state float32, RWKV's ``prev`` in the model's dtype)."""
    p_t, apply_j, apply_t, zero_j, zero_t, cfg_t = _mixer(mixer, dtype)
    p_j = {k: _jax(v) for k, v in p_t.items()}
    tol = F32_MIXER if dtype == "float32" else BF16_REL_L2
    x = np.random.default_rng(8).standard_normal((B, T + 1, cfg_t.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(tlm.dtype_of(cfg_t))
    xj = _jax(xt)

    y_j, _ = apply_j(p_j, xj[:, :T], None)
    y_t, _ = apply_t(p_t, xt[:, :T], None)
    _close(y_t, y_j, tol, f"{mixer}: output without a state")
    y_j, st_j = apply_j(p_j, xj[:, :T], zero_j)
    y_t, st_t = apply_t(p_t, xt[:, :T], zero_t)
    _close(y_t, y_j, tol, f"{mixer}: output from a zero state")
    for step in ("prefill", "decode"):
        assert set(st_t) == set(st_j), step
        for k in st_j:
            _same_dtype(st_t[k], st_j[k], f"{mixer} {step}: state {k}")
            _close(st_t[k], st_j[k], tol, f"{mixer} {step}: state {k}")
        if step == "prefill":
            y_j, st_j = apply_j(p_j, xj[:, T:], st_j)
            y_t, st_t = apply_t(p_t, xt[:, T:], st_t)
            _close(y_t, y_j, tol, f"{mixer}: decode output")
    if mixer == "mamba":
        assert st_t["conv"].dtype == st_t["ssd"].dtype == torch.float32


# --------------------------------------------------------------------------
# the LMs
# --------------------------------------------------------------------------

_JAX_STEPS: dict = {}


def _jax_steps(cfg_j, mesh, cache_len):
    """The JAX package's prefill and serve steps, jitted once per config
    and cache length (the cases of one shape share the compiled code)."""
    key = (cfg_j, cache_len)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = (jax.jit(jsteps.make_prefill_step(cfg_j, mesh, cache_len=cache_len)),
                           jax.jit(jsteps.make_serve_step(cfg_j, mesh)))
    return _JAX_STEPS[key]


def _cache_layers(cache_j, cfg_t):
    """The JAX cache's per-layer states in layer order (stacked like the
    parameters)."""
    return interop.lm_params_from_numpy(_np_tree(cache_j), cfg_t, "cpu")["layers"]


@pytest.mark.parametrize("name,over", [("zamba2", {}), ("rwkv6", {}),
                                       ("zamba2", dict(n_layers=3, dtype="bfloat16"))],
                         ids=["zamba2-f32", "rwkv6-f32", "zamba2-bf16"])
def test_prefill_and_decode_match_jax(mesh11, name, over):
    """Float32 at 9 and 2 layers; bf16 at 3 Mamba2 layers.  In bf16 each
    package drifts from its own float32 run by ~4e-3 more a layer (the
    first layer's caches agree across the packages to 1e-5, the fifth's
    ``ssd`` sits 2.2e-2 from float32 in both, and as far from the other
    package's: bf16 rounding, while float32 agrees to ~5e-7), so the bf16
    case takes a depth whose noise stays below ``BF16_REL_L2``, as
    ``test_torch_lm.py``'s two layers do."""
    cfg_j, cfg_t, params_j, params_t = _models(name, 1, **over)
    dtype = cfg_t.dtype
    tol = F32_LM if dtype == "float32" else BF16_REL_L2
    prefill_j, step_j = _jax_steps(cfg_j, mesh11, T + STEPS)
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab, (B, T + STEPS), dtype=np.int32)
    cache_j, logits_j = prefill_j(params_j, {"tokens": jnp.asarray(toks[:, :T])})
    cache_t, logits_t = tlm.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks[:, :T])},
                                    cache_len=T + STEPS)
    v = cfg_t.vocab
    assert logits_t.dtype == tlm.dtype_of(cfg_t) and bool((logits_t[:, v:] == -1e30).all())
    _close(logits_t[:, :v], logits_j[:, :v], tol, "prefill logits")

    def same_caches(what):
        for i, (lt, lj) in enumerate(zip(cache_t["layers"], _cache_layers(cache_j, cfg_t),
                                         strict=True)):
            assert set(lt) == set(lj), (what, i)
            for k in lj:
                assert lt[k].dtype == lj[k].dtype, (what, i, k)
                _close(lt[k], lj[k], tol, f"{what}: layer {i} cache {k}")
    same_caches("prefill")
    for n in range(STEPS):
        tt = toks[:, T + n:T + n + 1]
        logits_j, cache_j = step_j(params_j, cache_j, jnp.asarray(tt))
        logits_t, cache_t = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt))
        _close(logits_t[:, :v], logits_j[:, :v], tol, f"decode step {n} logits")
    same_caches("decode")
    assert cache_t["pos"] == int(cache_j["pos"]) == T + STEPS


@pytest.mark.parametrize("name", ["zamba2", "rwkv6"])
def test_serve_tokens_match_jax_loop(mesh11, name):
    """``serve`` gives the greedy tokens of a JAX serve loop on the same
    parameters and prompts; the last wave is padded."""
    cfg_j, cfg_t, params_j, params_t = _models(name, 2)
    requests, batch, gen = 3, B, STEPS
    prefill, decode = _jax_steps(cfg_j, mesh11, T + gen)
    prompts = np.random.default_rng(6).integers(0, cfg_j.vocab, (requests, T), dtype=np.int32)
    want = {i: [] for i in range(requests)}
    for w0 in range(0, requests, batch):
        active = list(range(w0, min(w0 + batch, requests)))
        wave = np.zeros((batch, T), np.int32)
        wave[:len(active)] = prompts[active]
        cache, logits = prefill(params_j, {"tokens": jnp.asarray(wave)})
        tok = jnp.argmax(logits, axis=-1)[:, None]
        for _ in range(gen):
            for j, rid in enumerate(active):
                want[rid].append(int(tok[j, 0]))
            logits, cache = decode(params_j, cache, tok.astype(jnp.int32))
            tok = jnp.argmax(logits, axis=-1)[:, None]
    assert tserve.serve(params_t, cfg_t, torch.from_numpy(prompts), batch, gen) == want


@pytest.mark.parametrize("name,dtype", [("zamba2", "float32"), ("zamba2", "bfloat16"),
                                        ("rwkv6", "bfloat16")])
def test_params_round_trip(name, dtype):
    """JAX pytree -> port -> JAX layout gives every leaf back bit for bit,
    and port -> JAX -> port every tensor: the SSM leaves (float32 ``a_log``,
    ``dt_bias``, ``d_skip``, ``w0``, ``u``), the stacked ``use_shared``
    marker and ``shared_attn``, in the tree, shapes and dtypes of JAX's
    ``abstract_params``."""
    cfg_j, cfg_t, params_j, params_t = _models(name, 3, dtype=dtype)
    if name == "zamba2":
        assert set(params_t) == {"embed", "final_norm", "shared_attn", "layers"}
        assert [sorted(bp) for bp in params_t["layers"][4:7]] == [
            ["ln1", "mamba"], ["ln1", "use_shared"], ["ln1", "mamba"]]
        assert params_t["layers"][5]["use_shared"].dtype == torch.float32
    else:
        assert sorted(params_t["layers"][0]) == ["cmix", "ln1", "ln2", "rwkv"]
    shapes = jlm.abstract_params(cfg_j)
    want = _np_tree(params_j)
    back = interop.lm_params_to_numpy(params_t, cfg_t)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(shapes)
    for (path, a), b, s in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape == s.shape and a.dtype == s.dtype, path
        assert np.array_equal(np.asarray(a, np.float32), b), path
    back_j = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), back, shapes)
    again = interop.lm_params_from_numpy(_np_tree(back_j), cfg_t, "cpu")
    for (path, a), (_, b) in zip(tlm._leaves(params_t), tlm._leaves(again), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_serve_cli(capsys, arch):
    assert tserve.main(["--arch", arch, "--reduced", "--cpu", "--requests", "3",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 9 tokens in ")
