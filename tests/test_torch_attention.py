"""The port's attention (plain versions, on the CPU) against the JAX package.

``flash_attention_plain`` and the port's oracle ``ref.flash_attention_ref``
against the JAX oracle ``ref.flash_attention_ref``, the Pallas kernel
``kernels/flash_attention.flash_attention`` (interpret mode) and the XLA
``blockwise_attention``; the layers (``rms_norm``, ``rotary``, ``mlp``)
and ``decode_attention``.  Same inputs from a numpy seed through both
packages.  Tolerances: float32 at ``atol = rtol = 3e-5`` (the sums run in
another order); bf16 at ``2e-2`` (one bf16 ulp is 2**-8 relative, and the
JAX oracle takes its logits in bf16 where the port takes them in f32).
The CUDA kernel is held against ``flash_attention_plain`` on the card
(``tests/test_torch_gpu_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

# tests/test_kernels.py's six flash-attention cases
CASES = [(2, 4, 2, 64, 64, 32, True, 0),
         (1, 8, 1, 128, 128, 64, True, 0),     # MQA
         (2, 4, 4, 64, 128, 32, True, 0),      # suffix-aligned
         (1, 2, 2, 96, 96, 32, True, 32),      # sliding window
         (1, 4, 2, 1, 256, 64, True, 0),       # decode-like
         (2, 2, 2, 64, 64, 16, False, 0)]      # bidirectional


def _qkv(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, hkv, tk, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    return q, k, v


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", CASES)
def test_flash_plain_vs_oracle_and_pallas(b, hq, hkv, tq, tk, d, causal, window):
    q, k, v = _qkv(b * 100 + tq + tk + d, b, hq, hkv, tq, tk, d)
    want = np.asarray(jref.flash_attention_ref(_jax(q), _jax(k), _jax(v), causal=causal,
                                               window=window))
    pallas = np.asarray(jfa.flash_attention(_jax(q), _jax(k), _jax(v), causal=causal,
                                            window=window, block_q=32, block_k=32))
    tq_, tk_, tv_ = _torch(q), _torch(k), _torch(v)
    plain = tfa.flash_attention_plain(tq_, tk_, tv_, causal=causal, window=window)
    oracle = tref.flash_attention_ref(tq_, tk_, tv_, causal=causal, window=window)
    assert plain.dtype == torch.float32 and plain.shape == (b, hq, tq, d)
    np.testing.assert_allclose(plain.numpy(), want, **F32)
    np.testing.assert_allclose(plain.numpy(), pallas, **F32)
    np.testing.assert_allclose(oracle.numpy(), want, **F32)
    # the dispatcher's CPU path is the plain version
    auto = tops.flash_attention(tq_, tk_, tv_, causal=causal, window=window)
    assert torch.equal(auto, plain)


def test_flash_plain_bf16_vs_oracle_and_pallas():
    q, k, v = _qkv(7, 1, 2, 2, 64, 64, 32)
    qj, kj, vj = (_jax(a, jnp.bfloat16) for a in (q, k, v))
    want = _f32(jref.flash_attention_ref(qj, kj, vj))
    pallas = _f32(jfa.flash_attention(qj, kj, vj, block_q=32, block_k=32))
    qt, kt, vt = (_torch(np.asarray(a, np.float32), torch.bfloat16) for a in (qj, kj, vj))
    plain = tfa.flash_attention_plain(qt, kt, vt)
    assert plain.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(plain), want, **BF16)
    np.testing.assert_allclose(_f32(plain), pallas, **BF16)
    np.testing.assert_allclose(_f32(tref.flash_attention_ref(qt, kt, vt)), want, **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,tq,tk,causal,window", [
    (4, 2, 80, 80, True, 24),       # GQA, window, Tk % k_block != 0
    (4, 1, 24, 80, True, 0),        # suffix-aligned queries
    (2, 2, 40, 40, False, 0)])      # bidirectional, padded keys
def test_flash_plain_vs_blockwise(dtype, hq, hkv, tq, tk, causal, window):
    """The model's prefill attention: the port's plain version against the
    JAX package's XLA ``blockwise_attention`` (both upcast to f32)."""
    q, k, v = _qkv(hq + tq + tk, 2, hq, hkv, tq, tk, 32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    qj, kj, vj = (_jax(a, jd) for a in (q, k, v))
    want = _f32(jattn.blockwise_attention(qj, kj, vj, causal=causal, window=window,
                                          q_block=32, k_block=16, q_offset=tk - tq))
    got = tfa.flash_attention_plain(*(_torch(np.asarray(a, np.float32), td)
                                      for a in (qj, kj, vj)), causal=causal, window=window)
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), want, **(F32 if dtype == "float32" else BF16))


def test_flash_plain_noncausal_padded_keys():
    """Non-causal with Tk = 40 and a key block of 32: the port masks the
    keys at kpos >= Tk and agrees with the oracle.  (The Pallas kernel
    diverges here, by 0.135 at these inputs: its wrapper swaps the window for Tk, so
    the zero-padded keys of the last block pass its mask and enter the
    normaliser; ``blockwise_attention`` masks them, as the port does.)"""
    q, k, v = _qkv(40, 1, 2, 2, 40, 40, 16)
    want = np.asarray(jref.flash_attention_ref(_jax(q), _jax(k), _jax(v), causal=False))
    got = tfa.flash_attention_plain(_torch(q), _torch(k), _torch(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_flash_impl_cuda_on_cpu_raises():
    q, k, v = (_torch(a) for a in _qkv(1, 1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rotary(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 12, 16)).astype(np.float32) * 2
    gamma = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 1, 12)).astype(np.int32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    tol = F32 if dtype == "float32" else BF16
    xj, gj = _jax(x, jd), _jax(gamma, jd)
    xt, gt = _torch(np.asarray(xj, np.float32), td), _torch(np.asarray(gj, np.float32), td)
    np.testing.assert_allclose(_f32(tlayers.rms_norm(xt, gt, 1e-6)),
                               _f32(jlayers.rms_norm(xj, gj, 1e-6)), **tol)
    got = tlayers.rotary(xt, torch.from_numpy(pos), 1e6)
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), _f32(jlayers.rotary(xj, jnp.asarray(pos), 1e6)),
                               **tol)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp(activation):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"w_in": rng.standard_normal((16, 24)).astype(np.float32) * 0.25,
         "w_out": rng.standard_normal((24, 16)).astype(np.float32) * 0.2}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = rng.standard_normal((16, 24)).astype(np.float32) * 0.25
    want = jlayers.mlp({n: _jax(a) for n, a in p.items()}, _jax(x), activation)
    got = tlayers.mlp({n: _torch(a) for n, a in p.items()}, _torch(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kv_len,lo", [(9, None), (20, None), (20, 11)])
def test_decode_attention(kv_len, lo):
    q, k, v = _qkv(kv_len, 2, 4, 2, 1, 20, 16)
    want = jattn.decode_attention(_jax(q), _jax(k), _jax(v), kv_len,
                                  lo=None if lo is None else jnp.int32(lo))
    got = tattn.decode_attention(_torch(q), _torch(k), _torch(v), kv_len, lo=lo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
