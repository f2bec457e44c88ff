"""The port's optimizer, schedule and gradient compression against the JAX package.

``adamw_update`` over three steps on a tree with a 128 x 160 matrix (so
the factored second moment applies), a 130 x 128 matrix in a list, and a
vector, from the same numpy gradients: factored and not, float32 and bf16
moments, the global-norm clip engaged and not; every state leaf and
parameter after each step at a relative L2 error of 1e-6 (both compute in
float32; sums run in another order).  ``warmup_cosine`` on a step sweep
(float32 values at 1e-6), ``int8_compress`` / ``int8_decompress`` bit for
bit against JAX's run op by op (under ``jax.jit`` XLA turns the division
by 127 into a multiply by its reciprocal and fuses the residual into an
FMA, which moves the last bit of some scales and residuals), and
``compressed_psum`` at one rank against JAX's under a 1 x 1 mesh (its
``shard_map`` compiles, so the same last-bit moves: the sum at 1e-6
relative, the residual within 1e-6 of the input's largest magnitude, a few
float32 ulps of the value it is the rounding error of), and bit for bit
against the port's own compress and decompress.  The other JAX references run jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch import tree
from repro_torch.core.backend import SerialBackend
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedule as tschedule
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REL = 1e-6
SHAPES = {"w": (128, 160), "b": (160,), "layers": [{"k": (130, 128)}]}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want, what):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= REL, f"{what}: relative L2 {err:.3g}"


def _draw(rng, scale):
    def one(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": one(SHAPES["w"]), "b": one(SHAPES["b"]),
            "layers": [{"k": one(SHAPES["layers"][0]["k"])}]}


@pytest.mark.parametrize("factored,moments,clip", [
    (False, "float32", True), (True, "float32", False),
    (False, "bfloat16", False), (True, "bfloat16", True)])
def test_adamw_matches_jax_over_three_steps(factored, moments, clip):
    jcfg = jadamw.AdamWConfig(moment_dtype=moments, factored=factored)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    p_np = _draw(rng, 0.05)
    p_j = jax.tree_util.tree_map(jnp.asarray, p_np)
    p_t = tree.map_tree(lambda a: torch.from_numpy(a.copy()), p_np)
    s_j, s_t = jadamw.adamw_init(jcfg, p_j), tadamw.adamw_init(tcfg, p_t)
    assert ("vr" in s_t["per_param"]["w"]) == factored
    upd = jax.jit(lambda p, g, s: jadamw.adamw_update(jcfg, p, g, s))
    for step in range(3):
        g_np = _draw(rng, 0.05 if clip else 1e-4)      # |g| ~ 14 or ~3e-3 against clip 1.0
        p_j, s_j, m_j = upd(p_j, jax.tree_util.tree_map(jnp.asarray, g_np), s_j)
        p_t, s_t, m_t = tadamw.adamw_update(
            tcfg, p_t, tree.map_tree(lambda a: torch.from_numpy(a), g_np), s_t)
        assert (float(m_t["grad_norm"]) > 1.0) == clip
        _rel(m_t["grad_norm"], m_j["grad_norm"], "grad_norm")
        assert int(s_t["step"]) == int(s_j["step"]) == step + 1
        for (path, got), want in zip(_with_paths(s_t["per_param"]),
                                     jax.tree_util.tree_leaves(s_j["per_param"])):
            _rel(got, want, f"step {step} state {path}")
            assert got.dtype == (torch.bfloat16 if moments == "bfloat16" and path[-1] in "mv"
                                 else torch.float32), path
        for got, want in zip(tree.leaves(p_t), jax.tree_util.tree_leaves(p_j)):
            _rel(got, want, f"step {step} params")


def _with_paths(t, path=()):
    """(path, leaf) in tree order."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _with_paths(t[k], (*path, k))
    elif isinstance(t, list):
        for i, x in enumerate(t):
            yield from _with_paths(x, (*path, str(i)))
    else:
        yield path, t


def test_warmup_cosine_sweep():
    steps = np.array([0, 1, 50, 99, 100, 101, 2500, 5000, 9999, 10000, 12000], np.int32)
    kw = dict(peak=3.0, warmup=100, total=10000, floor=0.1)
    want = np.asarray(jax.jit(lambda s: jschedule.warmup_cosine(s, **kw))(steps))
    got = tschedule.warmup_cosine(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    for s, w in zip(steps.tolist(), want):
        g = tschedule.warmup_cosine(s, **kw)
        assert isinstance(g, float) and abs(g - float(w)) <= REL * abs(float(w))


def test_int8_compress_bit_for_bit():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    res = (rng.standard_normal((64, 33)) * 1e-2).astype(np.float32)
    g[5] = 0.0                                   # an all-zero row: the 1e-12 scale floor
    g[7, 3] = 127.5 * np.abs(g[7]).max() / 127.0  # a value that rounds half to even
    for residual in (None, res):
        qj, sj, rj = (np.asarray(x) for x in jcompress.int8_compress(
            jnp.asarray(g), None if residual is None else jnp.asarray(residual)))
        qt, st, rt = tcompress.int8_compress(
            torch.from_numpy(g), None if residual is None else torch.from_numpy(residual))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy(), sj)
        np.testing.assert_array_equal(rt.numpy(), rj)
        np.testing.assert_array_equal(
            tcompress.int8_decompress(qt, st).numpy(),
            np.asarray(jcompress.int8_decompress(jnp.asarray(qj), jnp.asarray(sj))))
    v = rng.standard_normal((50,)).astype(np.float32)        # a vector: one row
    qj, sj, rj = (np.asarray(x) for x in jcompress.int8_compress(jnp.asarray(v)))
    qt, st, rt = tcompress.int8_compress(torch.from_numpy(v))
    assert st.shape == (1, 1)
    for got, want in ((qt, qj), (st, sj), (rt, rj)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_compressed_psum_one_rank(mesh11):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 40)).astype(np.float32)
    res = (rng.standard_normal((16, 40)) * 1e-3).astype(np.float32)
    fn = jax.jit(shard_map(lambda a, r: jcompress.compressed_psum(a, "data", r), mesh=mesh11,
                           in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))
    sj, rj = (np.asarray(t) for t in fn(jnp.asarray(x), jnp.asarray(res)))
    st, rt = tcompress.compressed_psum(torch.from_numpy(x), SerialBackend(),
                                       torch.from_numpy(res))
    np.testing.assert_allclose(st.numpy(), sj, rtol=REL, atol=0)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=REL * np.abs(x + res).max())
    q, scale, r = tcompress.int8_compress(torch.from_numpy(x), torch.from_numpy(res))
    assert torch.equal(st, tcompress.int8_decompress(q, scale)) and torch.equal(rt, r)
    # error feedback: the dequantized sum plus the residual is the input
    np.testing.assert_allclose(st.numpy() + rt.numpy(), x + res, rtol=0, atol=1e-6)
