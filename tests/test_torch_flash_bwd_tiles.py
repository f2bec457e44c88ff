"""The flash-attention backward kernel's tile algorithm, emulated in torch on the CPU.

``csrc/flash_attention_bwd.cu`` runs only on the card.  ``emulate`` repeats
its arithmetic here, tile by tile, in float32 as the kernel computes it:
the padded head dim and the tile size its instance takes, (a) the
pre-pass (each query tile's log-sum-exp recomputed over the key tiles it
visits with an online max and sum, and in the same pass ``delta =
sum_j P_ij dP_ij``, which is ``rowsum(dO o O)`` for the float32 O), (b)
each key tile's dK and dV summed over the query heads of its GQA group and
over the query tiles that can see it, (c) each query tile's dQ over its
visible key tiles, and the tile skipping of both walks (the skipped tiles
are asserted to hold no pair the mask keeps).  Inputs come from numpy with
a seed; the gradients are held against autograd through
``flash_attention_plain`` at a relative L2 error of 1e-5 on causal,
windowed, GQA, suffix-aligned ``Tq < Tk`` and non-causal ``Tq != Tk``
calls at D = 16, 64, 128 and 320.  Each fault the chip check plants into
the kernel (``flash_attention.bwd_fault``) must break that gate here too.
Run as a script, it prints each case's gaps and each fault's, and, on bf16
operands at T = 2048, the gaps with delta taken from the forward's output
rounded to bf16 instead (FlashAttention-2's way) against the kernel's.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REL_L2 = 1e-5
#: the padded head dims of the kernel's instances
DPS = (16, 64, 128, 256, 320)
FAULT_CAUSAL, FAULT_DELTA, FAULT_GROUP, FAULT_SCALE = 1, 2, 4, 8


def instance(d: int) -> tuple[int, int]:
    """(padded head dim, tile rows) of the instance serving head dim ``d``."""
    dp = next(x for x in DPS if d <= x)
    return dp, 64 if dp <= 128 else 32


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


def _check_skips(tq: int, tk: int, bt: int, causal: bool, window: int) -> None:
    """Every pair the mask keeps lies in a tile both walks visit."""
    i_all, j_all = torch.arange(tq), torch.arange(tk)
    for q0 in range(0, tq, bt):
        lo, hi = key_range(q0, bt, tq, tk, causal, window)
        seen = _seen(torch.arange(q0, q0 + bt), j_all, tq, tk, causal, window)
        assert not seen[:, :(lo // bt) * bt].any() and not seen[:, max(hi, 0):].any()
    for k0 in range(0, tk, bt):
        lo, hi = query_range(k0, bt, tq, tk, causal, window)
        seen = _seen(i_all, torch.arange(k0, k0 + bt), tq, tk, causal, window)
        assert not seen[:(lo // bt) * bt].any() and not seen[max(hi, 0):].any()


def emulate(q, k, v, do, causal: bool = True, window: int = 0, fault: int = 0, o=None):
    """(dq, dk, dv) as the three launches compute them; q/do (B,Hq,Tq,D),
    k/v (B,Hkv,Tk,D).  ``o`` (B,Hq,Tq,D), if given, is the output delta is
    taken from instead (``rowsum(dO o O)``), for comparison."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    dp, bt = instance(d)
    scale = np.float32(1.0 / d ** 0.5).item()
    _check_skips(tq, tk, bt, causal, window)
    # GQA: (B, Hkv, rep, T, D) views of the query-side operands
    qg, gg = (x.reshape(b, hkv, rep, tq, d) for x in (q, do))

    # (a) lse and delta per query tile, one online pass
    lse = torch.empty((b, hkv, rep, tq))
    delta = torch.empty((b, hkv, rep, tq))
    for q0 in range(0, tq, bt):
        qt, gt = _tile(qg, q0, bt, dp), _tile(gg, q0, bt, dp)
        m = torch.full((b, hkv, rep, bt), -torch.inf)
        ls = torch.zeros((b, hkv, rep, bt))
        pd = torch.zeros((b, hkv, rep, bt))
        lo, hi = key_range(q0, bt, tq, tk, causal, window)
        for k0 in range((lo // bt) * bt, hi, bt):
            s = torch.einsum("bgrid,bgjd->bgrij", qt, _tile(k, k0, bt, dp)) * scale
            dpr = torch.einsum("bgrid,bgjd->bgrij", gt, _tile(v, k0, bt, dp))
            s = s.masked_fill(~_seen(torch.arange(q0, q0 + bt), torch.arange(k0, k0 + bt), tq, tk,
                                     causal, window), -torch.inf)
            mn = torch.maximum(m, s.amax(-1))
            any_ = mn > -torch.inf
            p = torch.where(any_[..., None] & (s > -torch.inf), torch.exp(s - mn[..., None]), 0.0)
            alpha = torch.exp(m - mn)
            ls = torch.where(any_, ls * alpha + p.sum(-1), ls)
            pd = torch.where(any_, pd * alpha + (p * dpr).sum(-1), pd)
            m = torch.where(any_, mn, m)
        n = min(bt, tq - q0)
        lse[..., q0:q0 + n] = (m + torch.log(ls))[..., :n]
        delta[..., q0:q0 + n] = (pd / ls)[..., :n]
    if o is not None:
        delta = (gg.float() * o.reshape(b, hkv, rep, tq, d).float()).sum(-1)
    if fault & FAULT_DELTA:
        delta = torch.zeros_like(delta)

    def ds_of(qt, gt, kt, vt, lse_t, delta_t, q0, k0, causal_):
        """P and dS of a (query tile, key tile) pair: (..., bt, bt)."""
        s = torch.einsum("...id,...jd->...ij", qt, kt)
        dpr = torch.einsum("...id,...jd->...ij", gt, vt)
        seen = _seen(torch.arange(q0, q0 + bt), torch.arange(k0, k0 + bt), tq, tk, causal_,
                     window)
        p = torch.where(seen, torch.exp(s * scale - lse_t[..., None]), 0.0)
        return p, p * (dpr - delta_t[..., None])

    def rows(x, r0):
        out = x.new_zeros((*x.shape[:-1], bt))
        n = min(bt, x.shape[-1] - r0)
        out[..., :n] = x[..., r0:r0 + n]
        return out

    # (b) dK and dV per key tile, the group's query heads summed in the tile
    dk = torch.empty((b, hkv, tk, d))
    dv = torch.empty((b, hkv, tk, d))
    causal_b = causal and not fault & FAULT_CAUSAL
    heads = 1 if fault & FAULT_GROUP else rep
    for k0 in range(0, tk, bt):
        kt, vt = _tile(k, k0, bt, dp), _tile(v, k0, bt, dp)
        acc_k = torch.zeros((b, hkv, bt, dp))
        acc_v = torch.zeros((b, hkv, bt, dp))
        lo, hi = query_range(k0, bt, tq, tk, causal_b, window)
        for g in range(heads):
            for q0 in range((lo // bt) * bt, hi, bt):
                qt, gt = _tile(qg[:, :, g], q0, bt, dp), _tile(gg[:, :, g], q0, bt, dp)
                p, ds = ds_of(qt, gt, kt, vt, rows(lse[:, :, g], q0), rows(delta[:, :, g], q0),
                              q0, k0, causal_b)
                acc_v += torch.einsum("bgij,bgid->bgjd", p, gt)
                acc_k += torch.einsum("bgij,bgid->bgjd", ds, qt)
        n = min(bt, tk - k0)
        sc = 1.0 if fault & FAULT_SCALE else scale
        dk[:, :, k0:k0 + n] = (acc_k * sc)[:, :, :n, :d]
        dv[:, :, k0:k0 + n] = acc_v[:, :, :n, :d]

    # (c) dQ per query tile
    dq = torch.empty((b, hkv, rep, tq, d))
    for q0 in range(0, tq, bt):
        qt, gt = _tile(qg, q0, bt, dp), _tile(gg, q0, bt, dp)
        acc = torch.zeros((b, hkv, rep, bt, dp))
        lo, hi = key_range(q0, bt, tq, tk, causal, window)
        for k0 in range((lo // bt) * bt, hi, bt):
            kt, vt = _tile(k, k0, bt, dp)[:, :, None], _tile(v, k0, bt, dp)[:, :, None]
            _, ds = ds_of(qt, gt, kt, vt, rows(lse, q0), rows(delta, q0), q0, k0, causal)
            acc += torch.einsum("bgrij,bgrjd->bgrid", ds, kt.expand(-1, -1, rep, -1, -1))
        n = min(bt, tq - q0)
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


def gaps(case: tuple, seed: int = 0, fault: int = 0) -> dict:
    """Relative L2 of the emulated dq, dk, dv against autograd of the plain version."""
    b, hq, hkv, tq, tk, d, causal, window = case
    q, k, v, do = _inputs(seed, b, hq, hkv, tq, tk, d)
    got = emulate(q, k, v, do, causal=causal, window=window, fault=fault)
    want = tfa.flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window)
    return {n: rel_l2(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}


# (b, hq, hkv, tq, tk, d, causal, window)
CASES = {
    "causal_d64": (2, 2, 2, 100, 100, 64, True, 0),
    "window_d16": (1, 2, 2, 150, 150, 16, True, 40),
    "gqa_d128": (1, 4, 2, 70, 70, 128, True, 0),
    "suffix_tq_lt_tk": (1, 2, 1, 37, 130, 64, True, 0),
    "noncausal_tq_gt_tk": (1, 2, 2, 90, 33, 64, False, 0),
    "noncausal_tq_lt_tk": (1, 2, 2, 20, 75, 16, False, 0),
    "d320_window_gqa": (1, 4, 2, 70, 70, 320, True, 24),
}
#: each planted fault and a case where it must show (GQA's on a grouped case)
FAULTS = {FAULT_CAUSAL: "causal_d64", FAULT_DELTA: "causal_d64", FAULT_GROUP: "gqa_d128",
          FAULT_SCALE: "causal_d64"}


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_backward_vs_autograd(name):
    g = gaps(CASES[name])
    assert max(g.values()) <= REL_L2, (name, g)


def test_planted_faults_break_the_gate():
    for fault, name in FAULTS.items():
        g = gaps(CASES[name], fault=fault)
        assert max(g.values()) > 100 * REL_L2, (fault, name, g)


def test_instances_cover_every_head_dim():
    assert [instance(d)[0] for d in (1, 16, 17, 64, 65, 128, 129, 256, 257, 320)] == \
        [16, 16, 64, 64, 128, 128, 256, 256, 320, 320]
    with pytest.raises(StopIteration):
        instance(321)


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest L2 error of a row over the mean row norm (chip_smoke's)."""
    g, w = got.double(), want.double()
    return float((g - w).norm(dim=-1).max() / w.norm(dim=-1).mean())


def delta_from_output(t: int = 2048, d: int = 64, seed: int = 0) -> dict:
    """bf16 operands: the emulated kernel (delta in float32 from the
    softmax) and the same with delta from the forward's bf16 output, each
    rounded to bf16 and held against autograd through the plain version in
    bf16: (relative L2, row gap) of dq, dk, dv."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(seed, 1, 2, 2, t, t, d))
    want = tfa.flash_attention_bwd_plain(q, k, v, do)
    f = [x.float() for x in (q, k, v, do)]
    out = {}
    for name, o in (("kernel", None), ("delta from bf16 O", tfa.flash_attention_plain(q, k, v))):
        got = [x.to(torch.bfloat16) for x in emulate(*f, o=None if o is None else o.float())]
        out[name] = {n: (f"{rel_l2(g, w):.2e}", f"{row_gap(g, w):.3f}")
                     for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return out


def main() -> None:
    for name, case in CASES.items():
        print(name, {k: f"{x:.2e}" for k, x in gaps(case).items()})
    for fault, name in FAULTS.items():
        print(f"fault {fault} on {name}", {k: f"{x:.2e}" for k, x in gaps(CASES[name],
                                                                           fault=fault).items()})
    for name, g in delta_from_output().items():
        print(f"bf16 at T=2048, D=64, {name}: (relative L2, row gap)", g)


if __name__ == "__main__":
    main()
