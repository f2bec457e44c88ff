"""Flash attention forward: the hand-written CUDA kernels and their plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
and takes its plain PyTorch version, ``flash_attention_plain``, only for
CPU tensors.  On the card the dtype picks the route, both on the tensor
cores: bf16 runs ``flash_fwd_wgmma`` (wgmma fed by a TMA ring, counted by
the ``flash_attention`` kernel), float32 ``flash_fwd_tf32`` (counted by
``flash_attention_f32``): 3xTF32 ``mma.sync``, each operand split into
two TF32 halves and each product taken as three, which keeps float32
accuracy.  All of them compute what the
JAX package's Pallas kernel (``repro/kernels/flash_attention.py:82``)
and its XLA twin ``blockwise_attention`` (``repro/models/attention.py:32``)
compute: softmax attention with float32 logits, probabilities and accumulation,
suffix-aligned queries (query i at key position ``i + Tk - Tq``), a
causal mask, a sliding window of the last ``window`` keys, and GQA (query
head h reads kv head ``h // (Hq // Hkv)``).  Keys at ``kpos >= Tk`` never
count, whatever ``causal`` is (the Pallas kernel lets zero-padded keys
into a non-causal call when ``Tk`` is not a multiple of its key block;
the port follows the oracle).

``probs_bf16`` is ``blockwise_attention(probs_bf16=True)``
(``repro/models/attention.py:95-101``): the probabilities and V are
rounded to bf16 for the P V product, which accumulates in float32; the
normaliser sums the float32 probabilities.  Each route has instances of
its own for it (the bf16 route drops its P_lo pass, the float32 route
takes P V in one exact TF32 pass); ``last_instance`` says which instance
a call launched.

The backward, ``flash_attention_bwd``, launches ``csrc/flash_attention_bwd.cu``
(counted by ``flash_attention_bwd`` for bf16 and ``flash_attention_bwd_f32``
for float32; its products on the tensor cores, bf16 P and dS as three bf16
pieces, float32 as 3xTF32): the gradient of the same function, dq, dk and
dv in the operand dtype with float32 sums, from the operands and the
incoming gradient; each row's softmax max and normaliser and ``delta =
rowsum(dO o O)`` are recomputed in float32 (the forward writes none of
them, and its stored output is rounded to the operand dtype).  With
``probs_bf16`` it is the gradient of that function, the roundings passing
the gradient through unchanged: dV takes P rounded, dP takes V rounded,
dS the float32 P, and delta the rounded forward's output.  Its plain
version is autograd through ``flash_attention_plain``
(``flash_attention_bwd_plain``), whose roundings pass the gradient
through the same way.  :class:`FlashAttentionFn` puts the two kernels
behind ``torch.autograd.Function``; ``ops.flash_attention`` routes a CUDA
call that needs a gradient through it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel, library, register

_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_FLASH = register("flash_attention", Kernel(
    "flash_attention", "flash_attention_bf16_launch",
    [_P, _P, _P, _P] + [_LL] * 12 + [_INT] * 10 + [ctypes.POINTER(_INT)]))
_FLASH_F32 = register("flash_attention_f32", Kernel(
    "flash_attention", "flash_attention_f32_launch",
    [_P, _P, _P, _P] + [_LL] * 12 + [_INT] * 10 + [ctypes.POINTER(_INT)]))

_BWD_ARGS = [_INT] + [_P] * 9 + [_INT] * 10 + [ctypes.c_float, _INT]
_BWD = register("flash_attention_bwd", Kernel(
    "flash_attention_bwd", "flash_attention_bwd_launch", _BWD_ARGS))
_BWD_F32 = register("flash_attention_bwd_f32", Kernel(
    "flash_attention_bwd", "flash_attention_bwd_launch", _BWD_ARGS))

#: the instance each route launched last, as an index into ``bf16_instances()``
#: or ``f32_instances()`` (the launcher reports it; -1 before any launch)
last_instance = {"bf16": -1, "f32": -1}

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


class _Bf16Through(torch.autograd.Function):
    """``x`` rounded to bf16, as float32; the gradient passes unchanged (a
    cast would round it to bf16 too)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          probs_bf16: bool = False) -> torch.Tensor:
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) -> (B,Hq,Tq,D) in ``q.dtype``.

    The whole softmax at once in float32, on a grouped view of the query
    heads (K/V are not repeated).  A row with no key to see is NaN, as in
    the oracle.  ``probs_bf16``: the unnormalised probabilities (against
    the row's max) and V rounded to bf16 for P V, divided by the float32
    sum of the probabilities; under autograd the roundings pass the
    gradient through unchanged, and the row's max is a constant (it cancels
    where nothing is rounded).
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, tq, d).float()
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * (1.0 / d ** 0.5)
    logits.masked_fill_(~_mask(tq, tk, causal, window, q.device), float("-inf"))
    if probs_bf16:
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
        del logits
        out = torch.einsum("bgrqk,bgkd->bgrqd", _Bf16Through.apply(p),
                           _Bf16Through.apply(v.float())) / p.sum(dim=-1, keepdim=True)
        return out.reshape(b, hq, tq, d).to(q.dtype)
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


def _aligned_operand(t: torch.Tensor, dt: int) -> torch.Tensor:
    """``t`` itself where the kernel can read its rows as they are (head
    dim ``dt``, a 16-byte aligned base and 16-byte multiple strides), else
    a contiguous copy with the head dim zero-padded to ``dt``."""
    if (t.shape[-1] == dt and t.data_ptr() % 16 == 0
            and all(s > 0 and s * t.element_size() % 16 == 0 for s in t.stride()[:3])):
        return t
    out = t.new_zeros((*t.shape[:3], dt))
    out[..., :t.shape[-1]] = t
    return out


def _head_merged(b: int, tq: int, hq: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, Hq, Tq, D) view of a new contiguous (B, Tq, Hq, D) buffer."""
    return torch.empty((b, tq, hq, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    probs_bf16: bool = False) -> torch.Tensor:
    """Attention forward on the card; the plain version for CPU tensors.

    Dispatch by dtype: bf16 runs the wgmma kernel (one CTA per batch,
    head and 128-query tile, 64 at D > 256), float32 the 3xTF32 kernel
    (64-query tiles).  Any strides with a contiguous head dim (the
    model's head-split projections pass as views).  Both kernels read
    rows of q, k and v in 16-byte pieces (bf16 through TMA, float32 by
    ``cp.async``), which wants a 16-byte aligned base and strides: an
    operand without them, or with a head dim that is not a multiple of 8
    (bf16) or 4 (float32), is first copied once into a contiguous buffer
    whose head dim is padded with zeros to that multiple (a layout step of
    the same kernel route; no model of the repo needs it).  The output is
    a (B, Hq, Tq, D) view of a contiguous (B, Tq, Hq, D) buffer, so
    merging the heads back after it copies nothing.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     probs_bf16=probs_bf16)
    _check(q, k, v, causal)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    flags = (int(causal), max(int(window), 0), int(probs_bf16))
    inst = _INT(-1)
    if q.dtype == torch.float32:
        dt = -(-d // 4) * 4
        q, k, v = (_aligned_operand(t, dt) for t in (q, k, v))
        out = _head_merged(b, tq, hq, d, q)
        _FLASH_F32(q, k, v, out, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *out.stride()[:3], b, hq, hkv, tq, tk, dt, d, *flags, ctypes.byref(inst))
        last_instance["f32"] = inst.value
        return out
    dt = -(-d // 8) * 8
    q, k, v = (_aligned_operand(t, dt) for t in (q, k, v))
    out = _head_merged(b, tq, hq, dt, q)
    _FLASH(q, k, v, out, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], b, hq, hkv, tq, tk, dt, d, *flags, ctypes.byref(inst))
    last_instance["bf16"] = inst.value
    if dt != d:
        out = _head_merged(b, tq, hq, d, q).copy_(out[..., :d])
    return out


def flash_attention_bwd_plain(q, k, v, do, causal: bool = True, window: int = 0,
                              probs_bf16: bool = False):
    """(dq, dk, dv): autograd through :func:`flash_attention_plain`."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=causal, window=window, probs_bf16=probs_bf16)
        return torch.autograd.grad(out, qkv, do)


#: planted into the backward kernel by the checks that must catch it (0 in
#: every real call): 1 the causal mask dropped from the dK/dV launch, 2 delta
#: left zero, 4 a GQA group's dK and dV from its first query head only, 8 the
#: scale dropped from dS, 16 (bf16 at head dim 64, the wgmma instance) P and dS
#: as two bf16 pieces, 32 the probs_bf16 flag ignored
bwd_fault = 0


def flash_attention_bwd(q, k, v, do, causal: bool = True, window: int = 0,
                        probs_bf16: bool = False):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window,
    probs_bf16)`` given the gradient ``do`` of its output: the kernel on the
    card, :func:`flash_attention_bwd_plain` for CPU tensors.

    Any strides with a contiguous head dim (``do`` is made so if it is
    not); the gradients have their operand's strides (``empty_like``).
    The kernel copies rows of q, k, v and ``do`` into shared memory in
    16-byte pieces, so, as in the forward, an operand without a 16-byte
    aligned base and strides, or with a head dim that is not a multiple of
    8 (bf16) or 4 (float32), is first copied once with the head dim
    zero-padded to that multiple.  Each row's softmax max and normaliser
    and delta go to float32 scratch of (3, B, Hq, Tq rounded up to 128).
    With ``probs_bf16`` the float32 route reads a copy of V rounded to
    bf16 (bf16 V is exact).
    """
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window,
                                         probs_bf16=probs_bf16)
    _check(q, k, v, causal)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention_bwd do: want {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = q.dtype == torch.float32
    if f32 and probs_bf16:
        v = v.to(torch.bfloat16).float()
    dt = -(-d // (4 if f32 else 8)) * (4 if f32 else 8)
    q, k, v, do = (_aligned_operand(t, dt) for t in (q, k, v, do))
    stats = torch.empty((3, b, hq, -(-tq // 128) * 128), dtype=torch.float32, device=q.device)
    strides = torch.tensor([s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]],
                           dtype=torch.int64)
    (_BWD_F32 if f32 else _BWD)(int(f32), q, k, v, do, dq, dk, dv, stats, strides,
                                b, hq, hkv, tq, tk, d, dt, int(causal),
                                max(int(window), 0), int(probs_bf16), 1.0 / d ** 0.5, bwd_fault)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (CUDA
    tensors).  Saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, probs_bf16: bool = False):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.probs_bf16 = causal, window, probs_bf16
        return flash_attention(q, k, v, causal=causal, window=window, probs_bf16=probs_bf16)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, ctx.causal, ctx.window, ctx.probs_bf16)
        return dq, dk, dv, None, None, None


#: what an instance query returns past a route's last instance
_NO_INSTANCE = 1   # cudaErrorInvalidValue


def _instances(route: str) -> list[dict]:
    """A route's template instances as the card reports them, in the
    library's order: the widest head dim each takes, registers a thread
    at launch, local (spill) bytes and dynamic shared memory."""
    lib = library(_FLASH.source)
    fn = getattr(lib, f"flash_attention_{route}_instance")
    fn.argtypes = [_INT] + [ctypes.POINTER(_INT)] * 5
    fn.restype = _INT
    rows = []
    while True:
        vals = [_INT() for _ in range(5)]
        rc = fn(len(rows), *(ctypes.byref(x) for x in vals))
        if rc == _NO_INSTANCE and rows:
            return rows
        if rc != 0:
            raise RuntimeError(f"flash_attention_{route}_instance({len(rows)}): CUDA error {rc} "
                               f"({lib.kernel_error_string(rc).decode()})")
        row = dict(zip(("max_d", "probs_bf16", "registers", "local_bytes", "smem_bytes"),
                       (x.value for x in vals)))
        row["probs_bf16"] = bool(row["probs_bf16"])
        rows.append(row)


def bf16_instances() -> list[dict]:
    """The bf16 kernel's instances, one per 64 columns of head dim,
    without ``probs_bf16`` and then with it."""
    return _instances("bf16")


def f32_instances() -> list[dict]:
    """The float32 kernel's instances (head dims up to 16, 32, 64, 128,
    192, 256 and 320), without ``probs_bf16`` and then with it."""
    return _instances("f32")
