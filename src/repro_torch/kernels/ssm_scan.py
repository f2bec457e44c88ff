"""The recurrent mixers' scans: the hand-written CUDA kernels and their plain versions.

``mamba_scan`` and ``rwkv_scan`` launch ``csrc/ssm_scan.cu`` on CUDA
tensors and take their plain PyTorch versions (the ``*_plain`` functions
beside them) only for CPU tensors.  No Pallas kernel stands behind them:
they are the two ``lax.scan`` bodies of the JAX package's mixers
(``repro/models/ssm.py:98-109``, Mamba2's SSD recurrence, and ``:183-193``,
RWKV-6's), which eager PyTorch would run as a Python loop of several
launches a step.  The plain versions are that loop, step for step as
JAX's ``step`` computes it.

Both take float32 operands (the caller upcasts, as JAX's ``astype`` does)
and return float32 outputs and a new final state (the initial state is
not written).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binning import require
from repro_torch.kernels.build import Kernel, register

_F32 = torch.float32
_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_MAMBA = register("mamba_scan", Kernel(
    "ssm_scan", "mamba_scan_launch",
    [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _P, _P, _P] + [_INT] * 5))
_RWKV = register("rwkv_scan", Kernel(
    "ssm_scan", "rwkv_scan_launch", [_P] * 8 + [_INT] * 4))

#: the state widths each kernel has an instance for (registers hold a column)
MAMBA_STATES = (16, 32, 64, 128)
RWKV_HEADS = (16, 32, 64)
#: the widest head a mamba_scan CTA takes (one thread a column)
MAX_MAMBA_HEAD = 256


def mamba_scan_plain(x, dt, b, c, a, h0):
    """Mamba2's recurrence, one step at a time.

    x (B,T,H,P), dt (B,T,H), b and c (B,T,S), a (H,), h0 (B,H,S,P), all
    float32 -> (y (B,T,H,P), h (B,H,S,P)): ``h = h * exp(a dt) + b (x
    dt)`` (an outer product over s and p), ``y = sum_s c h``.
    """
    h, ys = h0, []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        decay = torch.exp(a[None] * dtt)                                  # (B,H)
        upd = b[:, t, None, :, None] * (x[:, t] * dtt[..., None])[:, :, None, :]
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bs,bhsp->bhp", c[:, t], h))
    return torch.stack(ys, 1), h


def rwkv_scan_plain(r, k, v, w, u, s0):
    """RWKV-6's recurrence, one step at a time.

    r, k, v, w (B,T,H,K), u (H,K), s0 (B,H,K,K), all float32 -> (out
    (B,T,H,K), s (B,H,K,K)): ``out = sum_k r (s + u k v)``, then ``s = w s
    + k v`` (outer products over k and v).
    """
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                  # (B,H,K,K)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1), s


def mamba_scan(x, dt, b, c, a, h0):
    """Mamba2's scan; CUDA: one CTA per (batch, head), one thread per head
    column, the state in registers.  x may be a strided view whose (H, P)
    part is contiguous (a slice of the conv output); b and c share their
    strides, each step's S contiguous."""
    if not x.is_cuda:
        return mamba_scan_plain(x, dt, b, c, a, h0)
    nb, t, nh, p = x.shape
    s = b.shape[-1]
    dev = x.device
    require(dt, "mamba_scan dt", _F32, (nb, t, nh), dev)
    require(a, "mamba_scan a", _F32, (nh,), dev)
    require(h0, "mamba_scan h0", _F32, (nb, nh, s, p), dev)
    for tt, name, shape in ((x, "x", (nb, t, nh, p)), (b, "b", (nb, t, s)),
                            (c, "c", (nb, t, s))):
        if tt.dtype != _F32 or tuple(tt.shape) != shape or tt.device != dev:
            raise ValueError(f"mamba_scan {name}: want a float32 tensor of shape {shape} on "
                             f"{dev}, got {tt.dtype} {tuple(tt.shape)} on {tt.device}")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError(f"mamba_scan x: each step's (H, P) must be contiguous, strides "
                         f"{x.stride()}")
    if b.stride() != c.stride() or b.stride(2) != 1:
        raise ValueError(f"mamba_scan b, c: want equal strides with S contiguous, got "
                         f"{b.stride()} and {c.stride()}")
    if s not in MAMBA_STATES or not 1 <= p <= MAX_MAMBA_HEAD or t == 0:
        raise ValueError(f"mamba_scan: d_state {s} (want one of {MAMBA_STATES}), head {p} "
                         f"(want 1..{MAX_MAMBA_HEAD}), T={t} (want >= 1)")
    y = torch.empty((nb, t, nh, p), dtype=_F32, device=dev)
    h = torch.empty_like(h0)
    _MAMBA(x, x.stride(0), x.stride(1), dt, b, c, b.stride(0), b.stride(1), a, h0, y, h,
           nb, t, nh, p, s)
    return y, h


def rwkv_scan(r, k, v, w, u, s0):
    """RWKV-6's scan; CUDA: one CTA per (batch, head), one thread per
    value column, the state in registers."""
    if not r.is_cuda:
        return rwkv_scan_plain(r, k, v, w, u, s0)
    nb, t, nh, hd = r.shape
    dev = r.device
    for tt, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        require(tt, f"rwkv_scan {name}", _F32, (nb, t, nh, hd), dev)
    require(u, "rwkv_scan u", _F32, (nh, hd), dev)
    require(s0, "rwkv_scan s0", _F32, (nb, nh, hd, hd), dev)
    if hd not in RWKV_HEADS or t == 0:
        raise ValueError(f"rwkv_scan: head {hd} (want one of {RWKV_HEADS}), T={t} (want >= 1)")
    out = torch.empty((nb, t, nh, hd), dtype=_F32, device=dev)
    s = torch.empty_like(s0)
    _RWKV(r, k, v, w, u, s0, out, s, nb, t, nh, hd)
    return out, s
