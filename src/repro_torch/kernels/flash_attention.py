"""Flash attention forward: the hand-written CUDA kernel and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
and takes its plain PyTorch version, ``flash_attention_plain``, only for
CPU tensors.  Both compute what the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py:82``) and its XLA twin
``blockwise_attention`` (``repro/models/attention.py:32``) compute:
softmax attention with float32 logits, probabilities and accumulation,
suffix-aligned queries (query i at key position ``i + Tk - Tq``), a
causal mask, a sliding window of the last ``window`` keys, and GQA (query
head h reads kv head ``h // (Hq // Hkv)``).  Keys at ``kpos >= Tk`` never
count, whatever ``causal`` is (the Pallas kernel lets zero-padded keys
into a non-causal call when ``Tk`` is not a multiple of its key block;
the port follows the oracle).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel, register

_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_FLASH = register("flash_attention", Kernel(
    "flash_attention", "flash_attention_launch",
    [_P, _P, _P, _P] + [_LL] * 12 + [_INT] * 9))

#: the widest head the kernel takes (gemma3-4b: 2560 / 8)
MAX_HEAD_DIM = 320
_DTYPES = (torch.bfloat16, torch.float32)


def _mask(tq: int, tk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Tq, Tk) bool: which keys each suffix-aligned query sees."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    seen = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        seen &= kpos <= qpos
    if window > 0:
        seen &= kpos > qpos - window
    return seen


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) -> (B,Hq,Tq,D) in ``q.dtype``.

    The whole softmax at once in float32, on a grouped view of the query
    heads (K/V are not repeated).  A row with no key to see is NaN, as in
    the oracle.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, tq, d).float()
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * (1.0 / d ** 0.5)
    logits.masked_fill_(~_mask(tq, tk, causal, window, q.device), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bgrqk,bgkd->bgrqd", probs, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)


def _check(q, k, v, causal: bool) -> None:
    """Raise unless the kernel takes these operands."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"flash_attention {name}: want a 4-D {q.dtype} CUDA tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention {name}: the head dim must be contiguous, "
                             f"strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} (want bfloat16 or float32)")
    b, hq, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside 1..{MAX_HEAD_DIM}")
    if tk == 0 or (causal and tq > tk):
        raise ValueError(f"flash_attention: Tq={tq}, Tk={tk}, causal={causal} leaves "
                         f"queries that see no key")
    if hq > 65535 or b > 65535:
        raise ValueError(f"flash_attention: batch {b} x heads {hq} exceed the grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention forward; CUDA: one CTA per (batch, head, 64-query tile).

    Any strides with a contiguous head dim (the model's head-split
    projections pass as views).  The output is a (B, Hq, Tq, D) view of a
    contiguous (B, Tq, Hq, D) buffer, so merging the heads back after it
    copies nothing.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, causal)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    _FLASH(q, k, v, out, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], b, hq, hkv, tq, tk, d, int(causal), max(int(window), 0),
           int(q.dtype == torch.bfloat16))
    return out
