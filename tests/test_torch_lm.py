"""The port's dense LM serving path (on the CPU) against the JAX package.

``reduced(qwen3-4b)`` and ``reduced(gemma3-4b)`` (sliding-window layers,
qk-norm, GeGLU; also with the window-capped ring cache) with the JAX
package's parameters carried across by ``interop.lm_params_from_numpy``:
prefill logits and caches, three decode steps, and the greedy tokens of
``launch.serve.serve`` against a JAX loop built from the JAX step
builders.  Tolerances: float32 logits and caches elementwise at
``atol = rtol = 1e-4`` (matmul and softmax sums run in another order);
the bf16 case at a relative L2 error of ``2e-2`` (XLA's CPU bf16 path
rounds at other places and computes ``logistic`` with its own
approximation, so single elements near zero move by more than one bf16
ulp of the logits' scale; at two layers the error is below 1e-2).  Configs
and the parameter round trip are exact.  The port's prefill attention
runs ``flash_attention_plain`` here; the kernel runs on the card
(``chip_smoke.py``'s serving path).
"""

import dataclasses

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
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_REL_L2 = 2e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
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


def _models(arch, seed, **over):
    """(JAX cfg, port cfg, JAX params, the same params in the port)."""
    cfg_j = jcfg.reduced(jcfg.get_config(arch), **over)
    cfg_t = tcfg.reduced(tcfg.get_config(arch), **over)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, params_j, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t,
                                                                "cpu")


def _cache_layers(cache_j, cfg_t):
    """The JAX cache's per-layer K/V in layer order (the cache is stacked
    like the parameters)."""
    return interop.lm_params_from_numpy(_np_tree(cache_j), cfg_t, "cpu")["layers"]


@pytest.mark.parametrize("arch,over,tol", [
    ("qwen3-4b", {}, F32),
    ("gemma3-4b", {}, F32),
    ("gemma3-4b", {"window_cache": True}, F32),
    ("qwen3-4b", {"dtype": "bfloat16"}, BF16_REL_L2)],
    ids=["qwen3-f32", "gemma3-f32", "gemma3-ring-f32", "qwen3-bf16"])
def test_prefill_and_decode_match_jax(mesh11, arch, over, tol):
    cfg_j, cfg_t, params_j, params_t = _models(arch, 1, **over)
    axes = Axes.from_mesh(mesh11)
    b, t, extra = 2, 24, 3          # the prompt outruns gemma's reduced window (16)
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab, (b, t + extra), dtype=np.int32)

    prefill_j = jax.jit(lambda p, bt: jlm.prefill(p, cfg_j, bt, cache_len=t + 4, mesh=mesh11,
                                                  axes=axes))
    step_j = jax.jit(lambda p, c, tt: jlm.decode_step(p, cfg_j, c, tt, mesh=mesh11, axes=axes))
    cache_j, logits_j = prefill_j(params_j, {"tokens": jnp.asarray(toks[:, :t])})
    cache_t, logits_t = tlm.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks[:, :t])},
                                    cache_len=t + 4)
    v = cfg_t.vocab
    assert logits_t.dtype == tlm.dtype_of(cfg_t) and logits_t.shape == (b, cfg_t.padded_vocab)
    assert bool((logits_t[:, v:] == -1e30).all()) and bool((logits_j[:, v:] == -1e30).all())
    _close(logits_t[:, :v], logits_j[:, :v], tol, "prefill logits")
    assert cache_t["pos"] == int(cache_j["pos"]) == t

    for n in range(extra):
        tt = toks[:, t + n:t + n + 1]
        logits_j, cache_j = step_j(params_j, cache_j, jnp.asarray(tt))
        logits_t, cache_t = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt))
        _close(logits_t[:, :v], logits_j[:, :v], tol, f"decode step {n} logits")
    assert cache_t["pos"] == int(cache_j["pos"]) == t + extra
    for i, (lt, lj) in enumerate(zip(cache_t["layers"], _cache_layers(cache_j, cfg_t))):
        for name in ("k", "v"):
            _close(lt[name], lj[name], tol, f"layer {i} cache {name}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-4b"])
def test_serve_tokens_match_jax_loop(mesh11, arch):
    """``serve`` gives the greedy tokens of the JAX package's serve loop
    (``repro/launch/serve.py``) on the same parameters and prompts; the
    last wave is padded."""
    cfg_j, cfg_t, params_j, params_t = _models(arch, 2)
    requests, batch, prompt_len, gen = 5, 2, 20, 6
    prompts = np.random.default_rng(6).integers(0, cfg_j.vocab, (requests, prompt_len),
                                                dtype=np.int32)
    prefill = jax.jit(jsteps.make_prefill_step(cfg_j, mesh11, cache_len=prompt_len + gen))
    decode = jax.jit(jsteps.make_serve_step(cfg_j, mesh11))
    want = {i: [] for i in range(requests)}
    for w0 in range(0, requests, batch):
        active = list(range(w0, min(w0 + batch, requests)))
        wave = np.zeros((batch, prompt_len), np.int32)
        wave[:len(active)] = prompts[active]
        cache, logits = prefill(params_j, {"tokens": jnp.asarray(wave)})
        tok = jnp.argmax(logits, axis=-1)[:, None]
        for _ in range(gen):
            for j, rid in enumerate(active):
                want[rid].append(int(tok[j, 0]))
            logits, cache = decode(params_j, cache, tok.astype(jnp.int32))
            tok = jnp.argmax(logits, axis=-1)[:, None]

    seen = []
    timings = {}
    got = tserve.serve(params_t, cfg_t, torch.from_numpy(prompts), batch, gen,
                       on_logits=lambda w, s, lg: seen.append((w, s, tuple(lg.shape))),
                       timings=timings)
    assert got == want
    n_waves = -(-requests // batch)
    assert seen == [(w, s, (batch, cfg_t.padded_vocab))
                    for w in range(n_waves) for s in range(gen + 1)]
    assert len(timings["prefill_s"]) == n_waves and len(timings["decode_s"]) == n_waves * gen

    # teacher forcing: fed other tokens, serve returns exactly those
    forced = torch.from_numpy((prompts[:, :gen] + 1) % cfg_t.vocab)
    got = tserve.serve(params_t, cfg_t, torch.from_numpy(prompts), batch, gen, forced=forced)
    assert got == {i: forced[i].tolist() for i in range(requests)}


def test_serve_steps_and_cli(capsys):
    """The step builders equal the model calls; the CLI prints the lines of
    ``repro.launch.serve`` on the CPU and refuses to run without a card unless
    asked for the CPU."""
    cfg = tcfg.reduced(tcfg.get_config("qwen3-4b"))
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    cache, logits = tsteps.make_prefill_step(cfg, cache_len=10)(params, {"tokens": toks})
    cache2, logits2 = tlm.prefill(params, cfg, {"tokens": toks}, cache_len=10)
    assert torch.equal(logits, logits2)
    tok = logits.argmax(-1)[:, None]
    step_logits, _ = tsteps.make_serve_step(cfg)(params, cache, tok)
    assert torch.equal(step_logits, tlm.decode_step(params, cfg, cache2, tok)[0])

    assert tserve.main(["--reduced", "--cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "6", "--gen", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 12 tokens in ")
    assert [line.split(":")[0] for line in out[1:]] == ["request 0", "request 1", "request 2"]
    if not torch.cuda.is_available():
        assert tserve.main(["--reduced"]) == 1


@pytest.mark.parametrize("arch,over", [("qwen3-4b", {}), ("gemma3-4b", {"n_layers": 8}),
                                       ("qwen3-4b", {"dtype": "bfloat16"})])
def test_params_round_trip(arch, over):
    """JAX pytree -> port -> JAX layout gives every leaf back (gemma at 8
    layers: one scanned unit plus two remainder blocks)."""
    cfg_j, cfg_t, params_j, params_t = _models(arch, 3, **over)
    assert len(params_t["layers"]) == cfg_t.n_layers
    back = interop.lm_params_to_numpy(params_t, cfg_t)
    want = _np_tree(params_j)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape, path
        assert np.array_equal(np.asarray(a, np.float32), b), path


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_match_jax(arch):
    """The port's copy of the registry: the same configs and reduced variants."""
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    for fn in (lambda m: m.get_config(arch), lambda m: m.reduced(m.get_config(arch))):
        a, b = fn(jcfg), fn(tcfg)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.head_dim, a.padded_vocab, a.layer_plan(), a.param_count()) == \
            (b.head_dim, b.padded_vocab, b.layer_plan(), b.param_count())
