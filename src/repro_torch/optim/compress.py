"""Int8 error-feedback gradient compression (the port of ``repro/optim/compress.py``).

Intra-pod gradients reduce at full precision; the slow cross-pod hop
all-reduces int8 with per-row scales, and the quantization error is fed
back into the next step's gradient (error feedback), so the sum of the
quantized gradient and the residual is the original.  ``int8_compress``
and ``int8_decompress`` are bit for bit the JAX package's (``torch.round``
rounds half to even, as ``jnp.round`` does).  ``compressed_psum`` runs
over a port :class:`~repro_torch.core.backend.Backend`'s all-gather; at
one rank it is the dequantized gradient (multi-rank training, ROADMAP
Queue 1 item 7d, runs it over more).
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def int8_compress(g: torch.Tensor, residual: torch.Tensor | None = None):
    """g (...) -> (q int8, scale float32 rowwise, new_residual float32)."""
    g = g.to(_F32) if residual is None else g.to(_F32) + residual
    flat = g.reshape(-1, g.shape[-1]) if g.dim() > 1 else g.reshape(1, -1)
    scale = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    deq = q.to(_F32) * scale
    new_residual = (flat - deq).reshape(g.shape)
    return (q.reshape(g.shape),
            scale.reshape(g.shape[:-1] + (1,) if g.dim() > 1 else (1, 1)), new_residual)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape=None) -> torch.Tensor:
    out = q.to(_F32) * scale
    return out if shape is None else out.reshape(shape)


def compressed_psum(x: torch.Tensor, bk, residual: torch.Tensor | None = None):
    """All-reduce ``x`` over the ranks of ``bk`` in int8 with error feedback:
    an int8 all-gather (a quarter of a float32 all-reduce's bytes) with
    each rank's float32 row scales beside it, then the dequantized sum.
    Returns (summed float32, new_residual)."""
    q, scale, new_res = int8_compress(x, residual)
    qs = bk.all_gather(q)
    ss = bk.all_gather(scale)
    return (qs.to(_F32) * ss).sum(dim=0), new_res
