"""The flash-attention backward kernel's tile algorithm, emulated in torch on the CPU.

``csrc/flash_attention_bwd.cu`` runs only on the card.  ``emulate`` repeats
its arithmetic here, tile by tile, as the kernel computes it: the instance a
head dim and dtype pick (``INSTANCES``, the source's ``Inst`` table: the rows
each launch owns and the rows of the tiles it streams), (a) the pre-pass
(each query row's max ``m`` of ``s c`` with ``c = log2(e) / sqrt(D)`` and
``1 / l`` for ``l = sum_j 2^(s c - m)``, over the key tiles it visits with an
online max and sum, and in the same pass ``delta = sum_j P_ij dP_ij``,
which is ``rowsum(dO o O)`` for the float32 O; later launches take ``P =
2^(s c - m) / l``), (b) each key tile's
dK and dV with the keys as the rows (``S^T = K Q^T``, ``dP^T = V dO^T``)
summed over the query heads of its GQA group and over the query tiles that
can see it, each tile's sum taken apart and added after it (the kernel's
partials), (c) each query tile's dQ over its
visible key tiles, and the tile skipping of all three walks (the skipped
tiles are asserted to hold no pair the mask keeps).

The products are the tensor cores' (``product``): on bf16 operands S and dP
take the bf16 values as they are, and P and dS enter dV, dK and dQ as three
bf16 pieces, ``bf16(x)``, then ``bf16`` of what it leaves, then of what both
leave (rounded to nearest even, as the kernel's ``split3``), three passes
multiplied in float32 (``passes=1`` or ``2``: the first pieces alone); on
float32 operands every product is 3xTF32, each operand split
into ``hi`` (rounded to TF32 to nearest, ties away from zero) and ``lo = x -
hi`` (of which the tensor cores read the top 19 bits), taken as ``lo*hi +
hi*lo + hi*hi`` in float32.

Inputs come from numpy with a seed; the gradients are held against autograd
through ``flash_attention_plain`` at a relative L2 error of 1e-5 on float32
causal, windowed, GQA, suffix-aligned ``Tq < Tk`` and non-causal ``Tq !=
Tk`` calls at D = 16, 64, 128, 192 (MLA's) and 320, and on bf16 operands at
the chip check's bf16 gates (relative L2 1e-3, row gap 0.1); with
``probs_bf16`` (the flag's instances: delta from a second pass of (a) over P
rounded against the row's max, dV from the rounded P, V rounded on the
float32 route) against autograd through the plain version with the flag,
whose roundings pass the gradient through unchanged.  Each fault the chip
check plants into the kernel (``flash_attention.bwd_fault``) must break the
float32 gate here too.  ``test_emulated_backward_vs_jax`` holds the float32
emulation against ``jax.vjp`` of the JAX package's ``blockwise_attention``.
Run as a script, it prints each case's gaps and each fault's, and, on bf16
operands at T = 2048, D = 64, the gaps with one, two and three passes of P
and dS, and with delta taken from the forward's output rounded to bf16
instead (FlashAttention-2's way).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REL_L2 = 1e-5
#: the chip check's bf16 gates (chip_smoke.BWD_REL_L2 / BWD_ROW_GAP)
BF16_REL_L2, BF16_ROW_GAP = 1e-3, 0.1
#: float32 emulation against jax.vjp of blockwise_attention: both sum in
#: float32 in other orders (and XLA's exp is not the kernel's exp2)
JAX_REL_L2 = 1e-5
#: the padded head dims of the kernel's instances
DPS = (16, 64, 128, 256, 320)
FAULT_CAUSAL, FAULT_DELTA, FAULT_GROUP, FAULT_SCALE, FAULT_PIECES, FAULT_FLAG = 1, 2, 4, 8, 16, 32
#: the source's Inst table: per dtype and padded head dim, (a) (rows owned,
#: rows streamed), (b) (keys owned, queries streamed), (c) (queries owned,
#: keys streamed); column splits and warp counts do not change the sums
INSTANCES = {
    torch.bfloat16: {16: ((64, 64), (64, 64), (64, 64)), 64: ((64, 64), (64, 64), (64, 64)),
                     128: ((64, 64), (64, 32), (64, 64)), 256: ((64, 32), (32, 32), (64, 32)),
                     320: ((64, 32), (32, 32), (64, 32))},
    torch.float32: {16: ((64, 32), (64, 32), (64, 32)), 64: ((64, 32), (64, 32), (64, 32)),
                    128: ((64, 64), (64, 16), (64, 16)), 256: ((32, 16), (32, 16), (32, 16)),
                    320: ((32, 16), (32, 16), (32, 16))},
}
PAD_ROWS = 128
LOG2E = 1.4426950408889634


def instance(d: int, dtype=torch.float32) -> tuple[int, tuple, tuple, tuple]:
    """(padded head dim, (a), (b), (c) tiles) of the instance serving head dim ``d``."""
    dp = next(x for x in DPS if d <= x)
    return (dp, *INSTANCES[dtype][dp])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel's split does: to nearest, ties away
    from zero, on the low 13 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF   # the top 19 bits read
    return hi, lo.view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, bf16: bool, split_a: bool,
            passes: int = 3) -> torch.Tensor:
    """einsum(eq, a, b) as the tensor cores take it.  bf16: a and b are
    exact bf16 values, or ``split_a`` (P, dS) splits a into ``passes`` bf16
    pieces, the smaller passes first; float32: 3xTF32."""
    if bf16:
        if not split_a:
            return torch.einsum(eq, a, b)
        parts = [_bf16(a)]
        for _ in range(passes - 1):            # each piece: what the others leave, in bf16
            parts.append(_bf16(a - sum(parts)))
        out = torch.einsum(eq, parts[0], b)
        for x in parts[1:]:
            out = torch.einsum(eq, x, b) + out
        return out
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _seen(i: torch.Tensor, j: torch.Tensor, tq: int, tk: int, causal: bool,
          window: int) -> torch.Tensor:
    """(len(i), len(j)) bool: the kernel's per-element mask."""
    qpos = i[:, None] + (tk - tq)
    ok = (i[:, None] < tq) & (j[None, :] < tk)
    if causal:
        ok &= j[None, :] <= qpos
    if window > 0:
        ok &= j[None, :] > qpos - window
    return ok


def key_range(q0: int, n: int, tq: int, tk: int, causal: bool, window: int):
    off = tk - tq
    hi = min(tk, q0 + n + off) if causal else tk
    lo = max(0, q0 + off - window + 1) if window > 0 else 0
    return lo, hi


def query_range(k0: int, n: int, tq: int, tk: int, causal: bool, window: int):
    off = tk - tq
    lo = max(0, k0 - off) if causal else 0
    hi = min(tq, k0 + n - 1 + window - off) if window > 0 else tq
    return lo, hi


def _tile(x: torch.Tensor, r0: int, n: int, dp: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x (..., T, D) as float32, zero past T and D."""
    out = x.new_zeros((*x.shape[:-2], n, dp), dtype=torch.float32)
    rows = x[..., r0:r0 + n, :].float()
    out[..., :rows.shape[-2], :x.shape[-1]] = rows
    return out


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """x[..., r0:r0 + n] zero past its end."""
    out = x.new_zeros((*x.shape[:-1], n))
    m = min(n, x.shape[-1] - r0)
    out[..., :m] = x[..., r0:r0 + m]
    return out


def _check_skips(tq: int, tk: int, causal: bool, window: int, bq_a: int, bk_a: int,
                 bk_b: int, bq_b: int, bq_c: int, bk_c: int) -> None:
    """Every pair the mask keeps lies in a tile each walk visits."""
    i_all, j_all = torch.arange(tq), torch.arange(tk)
    for bq, bk in ((bq_a, bk_a), (bq_c, bk_c)):
        for q0 in range(0, tq, bq):
            lo, hi = key_range(q0, bq, tq, tk, causal, window)
            seen = _seen(torch.arange(q0, q0 + bq), j_all, tq, tk, causal, window)
            assert not seen[:, :(lo // bk) * bk].any() and not seen[:, max(hi, 0):].any()
    for k0 in range(0, tk, bk_b):
        lo, hi = query_range(k0, bk_b, tq, tk, causal, window)
        seen = _seen(i_all, torch.arange(k0, k0 + bk_b), tq, tk, causal, window)
        assert not seen[:(lo // bq_b) * bq_b].any() and not seen[max(hi, 0):].any()


def emulate(q, k, v, do, causal: bool = True, window: int = 0, fault: int = 0, o=None,
            passes: int = 3, probs_bf16: bool = False):
    """(dq, dk, dv) as the three launches compute them; q/do (B,Hq,Tq,D),
    k/v (B,Hkv,Tk,D), bf16 or float32 (the route).  ``o`` (B,Hq,Tq,D), if
    given, is the output delta is taken from instead (``rowsum(dO o O)``),
    for comparison; ``passes`` (3 in the kernel) is how many bf16 pieces of
    P and dS go through the products.  ``probs_bf16``: the float32 route
    reads V rounded to bf16 (its wrapper's copy), (a) takes delta in a
    second pass over its key tiles from ``bf16(2^(s c - m))`` against the
    row's final max, and (b)'s dV takes ``bf16(2^(s c - m)) / l``."""
    probs_bf16 = probs_bf16 and not fault & FAULT_FLAG
    if probs_bf16:
        v = _bf16(v).to(v.dtype)
    bf16 = q.dtype == torch.bfloat16
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    dp, (bq_a, bk_a), (bk_b, bq_b), (bq_c, bk_c) = instance(d, q.dtype)
    if fault & FAULT_PIECES and bf16 and dp == 64:   # the wgmma instance's third piece zero
        passes = min(passes, 2)
    c = np.float32(LOG2E / math.sqrt(d)).item()
    scale = np.float32(1.0 / d ** 0.5).item()
    _check_skips(tq, tk, causal, window, bq_a, bk_a, bk_b, bq_b, bq_c, bk_c)
    # GQA: (B, Hkv, rep, T, D) views of the query-side operands
    qg, gg = (x.reshape(b, hkv, rep, tq, d) for x in (q, do))

    def s_and_dp(qt, gt, kt, vt, eq):
        return product(eq, qt, kt, bf16, False), product(eq, gt, vt, bf16, False)

    # (a) each row's m, 1 / l and delta per query tile, one online pass
    tqp = -(-tq // PAD_ROWS) * PAD_ROWS
    rmax = torch.zeros((b, hkv, rep, tqp))     # the row's max m, in log2 units
    linv = torch.zeros((b, hkv, rep, tqp))     # 1 / l
    delta = torch.zeros((b, hkv, rep, tqp))
    for q0 in range(0, tq, bq_a):
        qt, gt = _tile(qg, q0, bq_a, dp), _tile(gg, q0, bq_a, dp)
        m = torch.full((b, hkv, rep, bq_a), -torch.inf)
        ls = torch.zeros((b, hkv, rep, bq_a))
        pd = torch.zeros((b, hkv, rep, bq_a))
        lo, hi = key_range(q0, bq_a, tq, tk, causal, window)
        for k0 in range((lo // bk_a) * bk_a, hi, bk_a):
            s, dpr = s_and_dp(qt, gt, *(_tile(x, k0, bk_a, dp)[:, :, None].expand(-1, -1, rep, -1, -1)
                                        for x in (k, v)), "bgrid,bgrjd->bgrij")
            s = s.masked_fill(~_seen(torch.arange(q0, q0 + bq_a), torch.arange(k0, k0 + bk_a),
                                     tq, tk, causal, window), -torch.inf)
            mn = torch.maximum(m, s.amax(-1) * c)
            mref = torch.where(mn == -torch.inf, 0.0, mn)
            p = torch.where(s > -torch.inf, torch.exp2(s * c - mref[..., None]), 0.0)
            alpha = torch.exp2(m - mref)
            ls = ls * alpha + p.sum(-1)
            pd = pd * alpha + (p * dpr).sum(-1)
            m = mn
        if probs_bf16:                         # the second pass, against the final max
            mref = torch.where(m == -torch.inf, 0.0, m)
            pd = torch.zeros_like(pd)
            for k0 in range((lo // bk_a) * bk_a, hi, bk_a):
                s, dpr = s_and_dp(qt, gt, *(_tile(x, k0, bk_a, dp)[:, :, None]
                                            .expand(-1, -1, rep, -1, -1) for x in (k, v)),
                                  "bgrid,bgrjd->bgrij")
                seen = _seen(torch.arange(q0, q0 + bq_a), torch.arange(k0, k0 + bk_a),
                             tq, tk, causal, window)
                p = torch.where(seen, _bf16(torch.exp2(s * c - mref[..., None])), 0.0)
                pd = pd + (p * dpr).sum(-1)
        n = min(bq_a, tq - q0)
        rmax[..., q0:q0 + n] = m[..., :n]
        linv[..., q0:q0 + n] = (1.0 / ls)[..., :n]
        delta[..., q0:q0 + n] = (pd / ls)[..., :n]
    if o is not None:
        delta[..., :tq] = (gg.float() * o.reshape(b, hkv, rep, tq, d).float()).sum(-1)
    if fault & FAULT_DELTA:
        delta = torch.zeros_like(delta)

    # (b) dK and dV per key tile, keys as the rows; the group's heads walked
    # head-major
    dk = torch.empty((b, hkv, tk, d))
    dv = torch.empty((b, hkv, tk, d))
    causal_b = causal and not fault & FAULT_CAUSAL
    heads = 1 if fault & FAULT_GROUP else rep
    for k0 in range(0, tk, bk_b):
        kt, vt = _tile(k, k0, bk_b, dp), _tile(v, k0, bk_b, dp)
        lo, hi = query_range(k0, bk_b, tq, tk, causal_b, window)
        tiles = list(range((lo // bq_b) * bq_b, hi, bq_b)) if hi > lo else []
        acc_k = torch.zeros((b, hkv, bk_b, dp))
        acc_v = torch.zeros((b, hkv, bk_b, dp))
        for g, q0 in ((g, q0) for g in range(heads) for q0 in tiles):
            qt, gt = _tile(qg[:, :, g], q0, bq_b, dp), _tile(gg[:, :, g], q0, bq_b, dp)
            st, dpt = s_and_dp(kt, vt, qt, gt, "bgjd,bgid->bgji")
            seen = _seen(torch.arange(q0, q0 + bq_b), torch.arange(k0, k0 + bk_b), tq, tk,
                         causal_b, window).T
            e = torch.where(seen, torch.exp2(st * c - _rows(rmax[:, :, g], q0, bq_b)[:, :, None, :]),
                            0.0)
            li = _rows(linv[:, :, g], q0, bq_b)[:, :, None, :]
            pt = e * li
            dst = pt * (dpt - _rows(delta[:, :, g], q0, bq_b)[:, :, None, :])
            acc_v += product("bgji,bgid->bgjd", _bf16(e) * li if probs_bf16 else pt, gt, bf16,
                             True, passes)
            acc_k += product("bgji,bgid->bgjd", dst, qt, bf16, True, passes)
        n = min(bk_b, tk - k0)
        sc = 1.0 if fault & FAULT_SCALE else scale
        dk[:, :, k0:k0 + n] = (acc_k * sc)[:, :, :n, :d]
        dv[:, :, k0:k0 + n] = acc_v[:, :, :n, :d]

    # (c) dQ per query tile
    dq = torch.empty((b, hkv, rep, tq, d))
    for q0 in range(0, tq, bq_c):
        qt, gt = _tile(qg, q0, bq_c, dp), _tile(gg, q0, bq_c, dp)
        acc = torch.zeros((b, hkv, rep, bq_c, dp))
        m_t, delta_t = _rows(rmax, q0, bq_c)[..., None], _rows(delta, q0, bq_c)[..., None]
        linv_t = _rows(linv, q0, bq_c)[..., None]
        lo, hi = key_range(q0, bq_c, tq, tk, causal, window)
        for k0 in range((lo // bk_c) * bk_c, hi, bk_c):
            kt, vt = (_tile(x, k0, bk_c, dp)[:, :, None].expand(-1, -1, rep, -1, -1)
                      for x in (k, v))
            s, dpr = s_and_dp(qt, gt, kt, vt, "bgrid,bgrjd->bgrij")
            seen = _seen(torch.arange(q0, q0 + bq_c), torch.arange(k0, k0 + bk_c), tq, tk,
                         causal, window)
            p = torch.where(seen, torch.exp2(s * c - m_t) * linv_t, 0.0)
            ds = p * (dpr - delta_t)
            acc += product("bgrij,bgrjd->bgrid", ds, kt, bf16, True, passes)
        n = min(bq_c, tq - q0)
        sc = 1.0 if fault & FAULT_SCALE else scale
        dq[..., q0:q0 + n, :] = (acc * sc)[..., :n, :d]
    cast = q.dtype
    return dq.reshape(b, hq, tq, d).to(cast), dk.to(cast), dv.to(cast)


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    do = torch.from_numpy(rng.standard_normal((b, hq, tq, d), dtype=np.float32))
    return q, k, v, do


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest L2 error of a row over the mean row norm (chip_smoke's)."""
    g, w = got.double(), want.double()
    return float((g - w).norm(dim=-1).max() / w.norm(dim=-1).mean())


def gaps(case: tuple, seed: int = 0, fault: int = 0, dtype=torch.float32,
         probs_bf16: bool = False) -> dict:
    """Relative L2 (and, on bf16, row gap) of the emulated dq, dk, dv
    against autograd of the plain version on the same operands."""
    b, hq, hkv, tq, tk, d, causal, window = case
    q, k, v, do = (x.to(dtype) for x in _inputs(seed, b, hq, hkv, tq, tk, d))
    got = emulate(q, k, v, do, causal=causal, window=window, fault=fault, probs_bf16=probs_bf16)
    want = tfa.flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window,
                                         probs_bf16=probs_bf16)
    if dtype == torch.float32:
        return {n: rel_l2(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return {n: (rel_l2(g, w), row_gap(g, w)) for n, g, w in zip(("dq", "dk", "dv"), got, want)}


# (b, hq, hkv, tq, tk, d, causal, window)
CASES = {
    "causal_d64": (2, 2, 2, 100, 100, 64, True, 0),
    "window_d16": (1, 2, 2, 150, 150, 16, True, 40),
    "gqa_d128": (1, 4, 2, 70, 70, 128, True, 0),
    "suffix_tq_lt_tk": (1, 2, 1, 37, 130, 64, True, 0),
    "noncausal_tq_gt_tk": (1, 2, 2, 90, 33, 64, False, 0),
    "noncausal_tq_lt_tk": (1, 2, 2, 20, 75, 16, False, 0),
    "d320_window_gqa": (1, 4, 2, 70, 70, 320, True, 24),
    "mla_d192": (1, 4, 4, 80, 80, 192, True, 0),
}
#: each planted fault and a case where it must show (GQA's on a grouped case)
FAULTS = {FAULT_CAUSAL: "causal_d64", FAULT_DELTA: "causal_d64", FAULT_GROUP: "gqa_d128",
          FAULT_SCALE: "causal_d64"}
#: bf16 operands: the wgmma instance (D = 64, causal GQA), a windowed mma.sync
#: one (D = 128) and a non-causal Tq != Tk call
BF16_CASES = {
    "bf16_gqa_d64": (1, 4, 2, 130, 130, 64, True, 0),
    "bf16_window_d128": (1, 2, 2, 100, 100, 128, True, 30),
    "bf16_noncausal_d64": (1, 2, 1, 70, 40, 64, False, 0),
    "bf16_mla_d192": (1, 4, 4, 100, 100, 192, True, 0),
}
#: probs_bf16 (the flag's instances of (a) and (b)): the wgmma instance, the
#: D = 192 (MLA) one, and on float32 operands a windowed GQA call and D = 192
PB_CASES = {
    "pb_bf16_gqa_d64": ((1, 4, 2, 130, 130, 64, True, 0), torch.bfloat16),
    "pb_bf16_mla_d192": ((1, 4, 4, 100, 100, 192, True, 0), torch.bfloat16),
    "pb_f32_window_gqa_d64": ((1, 4, 2, 90, 90, 64, True, 30), torch.float32),
    "pb_f32_mla_d192": ((1, 2, 2, 70, 70, 192, True, 0), torch.float32),
}
#: probs_bf16 on float32 operands: the emulation takes P from exp2 against
#: the row's max, the plain version from exp, and where the two float32
#: values lie on either side of a bf16 rounding midpoint the rounded P
#: differs by one bf16 step (2**-8 of it) in that element (1.1e-4 seen, dv
#: at D = 192).  On bf16 operands the chip check's probs_bf16 gate
#: (chip_smoke.PB_REL_L2): 4.9e-5 seen.  Ignoring the flag moves the
#: gradients by P's and V's bf16 rounding, 1.0e-3 to 2.1e-3 seen, which each
#: gate must see by twice its limit
PB_F32_REL_L2, PB_BF16_REL_L2 = 2e-4, 5e-4


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_backward_vs_autograd(name):
    g = gaps(CASES[name])
    assert max(g.values()) <= REL_L2, (name, g)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_emulated_bf16_backward_vs_autograd(name):
    g = gaps(BF16_CASES[name], dtype=torch.bfloat16)
    assert all(r <= BF16_REL_L2 and gap <= BF16_ROW_GAP for r, gap in g.values()), (name, g)


@pytest.mark.parametrize("name", list(PB_CASES))
def test_emulated_probs_bf16_backward_vs_autograd(name):
    case, dtype = PB_CASES[name]
    g = gaps(case, dtype=dtype, probs_bf16=True)
    if dtype == torch.float32:
        assert max(g.values()) <= PB_F32_REL_L2, (name, g)
    else:
        assert all(r <= PB_BF16_REL_L2 and gap <= BF16_ROW_GAP for r, gap in g.values()), \
            (name, g)


@pytest.mark.parametrize("name", list(PB_CASES))
def test_probs_bf16_flag_ignored_breaks_the_gate(name):
    """The chip check's fault 32 (the backward ignores the flag) must break
    the probs_bf16 gate by twice its limit."""
    case, dtype = PB_CASES[name]
    g = gaps(case, dtype=dtype, probs_bf16=True, fault=FAULT_FLAG)
    worst = max(x[0] if dtype == torch.bfloat16 else x for x in g.values())
    limit = PB_BF16_REL_L2 if dtype == torch.bfloat16 else PB_F32_REL_L2
    assert worst > 2 * limit, (name, g)


def test_planted_faults_break_the_gate():
    for fault, name in FAULTS.items():
        g = gaps(CASES[name], fault=fault)
        assert max(g.values()) > 100 * REL_L2, (fault, name, g)


def test_instances_cover_every_head_dim():
    assert [instance(d)[0] for d in (1, 16, 17, 64, 65, 128, 129, 256, 257, 320)] == \
        [16, 16, 64, 64, 128, 128, 256, 256, 320, 320]
    with pytest.raises(StopIteration):
        instance(321)


JAX_CASES = {
    "causal_gqa": (1, 4, 2, 48, 48, 16, True, 0),
    "window": (1, 2, 2, 40, 40, 32, True, 12),
    "noncausal_tq_ne_tk": (1, 2, 1, 24, 40, 16, False, 0),
}


def test_emulated_backward_vs_jax():
    """The float32 emulation against jax.vjp of the JAX package's
    blockwise_attention (suffix-aligned: q_offset = Tk - Tq) at JAX_REL_L2
    (3.1e-7 to 3.8e-7 seen).  The vjp runs under one jax.jit: eagerly, each
    case took ~2 s of op-by-op compiles."""
    for name, (b, hq, hkv, tq, tk, d, causal, window) in JAX_CASES.items():
        q, k, v, do = _inputs(7, b, hq, hkv, tq, tk, d)

        def f(q_, k_, v_, causal=causal, window=window, off=tk - tq):
            return jattn.blockwise_attention(q_, k_, v_, causal=causal, window=window,
                                             q_offset=off)
        grads = jax.jit(lambda q_, k_, v_, do_, f=f: jax.vjp(f, q_, k_, v_)[1](do_))
        want = [torch.from_numpy(np.array(x))
                for x in grads(*(jnp.asarray(x.numpy()) for x in (q, k, v, do)))]
        got = emulate(q, k, v, do, causal=causal, window=window)
        g = {n: rel_l2(x, y) for n, x, y in zip(("dq", "dk", "dv"), got, want)}
        assert max(g.values()) <= JAX_REL_L2, (name, g)


def bf16_passes_and_delta(t: int = 2048, d: int = 64, seed: int = 0) -> dict:
    """bf16 operands at T = t: the emulated kernel (three passes of P and
    dS, delta in float32 from the softmax), the same with one pass and with
    two, and with delta from the forward's bf16 output, each rounded to bf16
    and held against autograd through the plain version in bf16: (relative
    L2, row gap) of dq, dk, dv."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(seed, 1, 2, 2, t, t, d))
    want = tfa.flash_attention_bwd_plain(q, k, v, do)
    out = {}
    for name, kw in (("three passes (the kernel)", {}), ("two passes", {"passes": 2}),
                     ("one pass", {"passes": 1}),
                     ("delta from bf16 O", {"o": tfa.flash_attention_plain(q, k, v)})):
        got = emulate(q, k, v, do, **kw)
        out[name] = {n: (f"{rel_l2(g, w):.2e}", f"{row_gap(g, w):.3f}")
                     for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return out


def main() -> None:
    for name, case in CASES.items():
        print(name, {k: f"{x:.2e}" for k, x in gaps(case).items()})
    for name, case in BF16_CASES.items():
        print(name, {k: (f"{r:.2e}", f"{x:.3f}") for k, (r, x) in
                     gaps(case, dtype=torch.bfloat16).items()})
    for fault, name in FAULTS.items():
        print(f"fault {fault} on {name}", {k: f"{x:.2e}" for k, x in gaps(CASES[name],
                                                                           fault=fault).items()})
    for name, g in bf16_passes_and_delta().items():
        print(f"bf16 at T=2048, D=64, {name}: (relative L2, row gap)", g)


if __name__ == "__main__":
    main()
