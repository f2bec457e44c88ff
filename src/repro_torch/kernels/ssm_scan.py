"""The recurrent mixers' scans: the hand-written CUDA kernels and their plain versions.

``mamba_scan`` and ``rwkv_scan`` launch ``csrc/ssm_scan.cu`` on CUDA
tensors and take their plain PyTorch versions (the ``*_plain`` functions
beside them) only for CPU tensors.  No Pallas kernel stands behind them:
they are the two ``lax.scan`` bodies of the JAX package's mixers
(``repro/models/ssm.py:98-109``, Mamba2's SSD recurrence, and ``:183-193``,
RWKV-6's), which eager PyTorch would run as a Python loop of several
launches a step.  The plain versions are that loop, step for step as
JAX's ``step`` computes it.

``mamba_scan`` has two routes on the card, chosen by shape
(:func:`mamba_route`), each a kernel with its own launch counter: the
chunked SSD form on the tensor cores in 3xTF32 (``"mamba_scan"``) for
calls of :data:`SSD_CHUNK` steps or more, and the sequential kernel, one
thread a head column (``"mamba_scan_seq"``), below that, at decode, and for
heads wider than the chunked kernel's warps cover.  The sequential route
rounds each state update as the plain step does, so its final state is the
plain version's bit for bit; the chunked route's is held at a relative L2
of 1e-5.  ``rwkv_scan`` has one route, the exact sequential recurrence,
and its final state is the plain version's bit for bit.

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

_MAMBA_ARGS = [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _P, _P, _P] + [_INT] * 5
_MAMBA = register("mamba_scan", Kernel("ssm_scan", "mamba_ssd_launch",
                                       _MAMBA_ARGS + [_INT] * 3))
_MAMBA_SEQ = register("mamba_scan_seq", Kernel("ssm_scan", "mamba_seq_launch", _MAMBA_ARGS))
_RWKV = register("rwkv_scan", Kernel(
    "ssm_scan", "rwkv_scan_launch", [_P] * 8 + [_INT] * 5))

#: the state widths each kernel has an instance for (registers hold a column)
MAMBA_STATES = (16, 32, 64, 128)
RWKV_HEADS = (16, 32, 64)
#: the widest head a mamba_scan CTA takes (the sequential route: one thread a column)
MAX_MAMBA_HEAD = 256
#: steps a chunk of the chunked route: a call of fewer steps takes the sequential route
SSD_CHUNK = 32
#: warps a chunked CTA holds at most (each warp owns 16 head columns)
SSD_MAX_WARPS = 8
_SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100


def _ssd_smem(s: int, heads: int, wp: int) -> int:
    """Bytes of shared memory a chunked CTA takes (``ssd::smem_floats``):
    B and C x2, G; a head's x x2, M, dt x2, cs, W and exp(cs)."""
    chunk, ld_m = SSD_CHUNK, SSD_CHUNK + 4
    head = 2 * chunk * (16 * wp + 8) + chunk * ld_m + 5 * chunk
    return 4 * (4 * chunk * (s + 8) + chunk * ld_m + heads * head)


def mamba_route(t: int, nh: int, p: int, s: int) -> int:
    """Heads a CTA of the chunked route covers for a call of T = ``t``
    steps, ``nh`` heads of ``p`` columns and d_state ``s``; 0 picks the
    sequential route (fewer steps than a chunk, or a head wider than the
    chunked kernel's warps cover).  Two heads share B, C and C B^T where
    ``nh`` is even and their warps fit (at zamba2-7b's prefill call on an
    H100, 2 heads a CTA ran faster than 1 and no slower than 4), else one."""
    wp = -(-p // 16)
    if t < SSD_CHUNK:
        return 0
    for heads in (2, 1):
        if (heads * wp <= SSD_MAX_WARPS and nh % heads == 0
                and _ssd_smem(s, heads, wp) <= _SMEM_LIMIT):
            return heads
    return 0


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


def _aligned(*ts) -> bool:
    return all(tt.data_ptr() % 16 == 0 for tt in ts)


def mamba_scan(x, dt, b, c, a, h0):
    """Mamba2's scan; CUDA: the chunked route (:func:`mamba_route`) or the
    sequential one.  x may be a strided view whose (H, P) part is contiguous
    (a slice of the conv output); b and c share their strides, each step's
    S contiguous."""
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
    xs, bs = x.stride(), b.stride()
    if xs[3] != 1 or xs[2] != p:
        raise ValueError(f"mamba_scan x: each step's (H, P) must be contiguous, strides {xs}")
    if c.stride() != bs or bs[2] != 1:
        raise ValueError(f"mamba_scan b, c: want equal strides with S contiguous, got "
                         f"{bs} and {c.stride()}")
    if s not in MAMBA_STATES or not 1 <= p <= MAX_MAMBA_HEAD or t == 0:
        raise ValueError(f"mamba_scan: d_state {s} (want one of {MAMBA_STATES}), head {p} "
                         f"(want 1..{MAX_MAMBA_HEAD}), T={t} (want >= 1)")
    heads = mamba_route(t, nh, p, s)
    y = torch.empty((nb, t, nh, p), dtype=_F32, device=dev)
    h = torch.empty_like(h0)
    args = (x, xs[0], xs[1], dt, b, c, bs[0], bs[1], a, h0, y, h, nb, t, nh, p, s)
    if heads:
        # 16-byte copies where every row start of x, b and c is 16-byte aligned
        vec_x = _aligned(x) and xs[0] % 4 == 0 and xs[1] % 4 == 0 and p % 4 == 0
        vec_bc = _aligned(b, c) and bs[0] % 4 == 0 and bs[1] % 4 == 0
        _MAMBA(*args, heads, int(vec_x), int(vec_bc))
    else:
        _MAMBA_SEQ(*args)
    return y, h


def rwkv_scan(r, k, v, w, u, s0):
    """RWKV-6's scan; CUDA: one CTA per (batch, head), four threads a value
    column, the state in registers, the operands staged by cp.async."""
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
    _RWKV(r, k, v, w, u, s0, out, s, nb, t, nh, hd, int(_aligned(r, k, v, w)))
    return out, s
