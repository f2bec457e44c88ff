"""The float32 flash-attention kernel's tile algorithm, emulated in torch on the CPU.

``csrc/flash_attention.cu``'s float32 route (``flash_fwd_tf32``) runs
only on the card.  ``emulate`` repeats its arithmetic here, tile by tile:
the instance a head dim picks (64 query rows a CTA, 64 or 32 keys a
tile), the key tiles a query tile visits, the per-element mask on edge
tiles only, ``p = exp2(s * c - m)`` with the folded multiplier ``c =
log2(e) / sqrt(D)``, and 3xTF32: every operand of both products (Q and K
for S, P and V for O) split into ``hi``, x rounded to TF32 as ``cvt.rna``
rounds (to nearest, ties away from zero, on the low 13 mantissa bits;
the kernel adds half of them and masks, as done here on the bits), and
``lo = x - hi``, of which the tensor cores read the top 19 bits (TF32 by
truncation); each product is taken as ``lo*hi + hi*lo + hi*hi`` in
float32.  It is held against the JAX oracle
``ref.flash_attention_ref``, the Pallas kernel in interpret mode and
``flash_attention_plain`` at the card's float32 gate, ``atol = rtol =
3e-5``.  One TF32 pass alone (``passes=1``) breaks that gate.  The
``probs_bf16`` instances (P and V rounded to bf16, P V in one exact TF32
pass) are held against ``flash_attention_plain(probs_bf16=True)`` at that
gate plus ``2**-8`` of the attention-weighted mean of ``|V|``: each side
rounds each probability to bf16 against its own running max (2**-9 of it
at most).  Inputs come from numpy with a seed.  Run as a script, it prints the largest
error against the plain version with three passes and with one.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 3e-5
#: the probs_bf16 allowance, in units of the weighted mean of |V| (two bf16 roundings)
PROBS_BF16_RTOL = 2.0 ** -8
BQ = 64           # query rows a CTA
# (widest head dim, keys a tile, two warps on each 16 rows): the kernel's
# instances, in the order of the source's table (f32::with_instance)
INSTANCES = [(int(dp), int(bk), split == "true") for dp, bk, split in re.findall(
    r"flash_fwd_tf32<Cfg<(\d+), (\d+), (true|false), PB>>",
    (Path(tfa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text())]
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on the H100


def instance(d: int) -> tuple[int, int, bool]:
    for dp, bk, split in INSTANCES:
        if d <= dp:
            return dp, bk, split
    raise ValueError(d)


def pitches(dp: int) -> tuple[int, int]:
    """Row pitches (floats) of the Q and K tiles (16 mod 32) and of the V tile."""
    return dp + (32 if dp % 32 else 16), dp + 4


def smem_bytes(dp: int, bk: int) -> int:
    """The raw float32 Q tile and one K and one V tile at their pitches."""
    lk, lv = pitches(dp)
    return ((BQ + bk) * lk + bk * lv) * 4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: keep 10 mantissa bits,
    to nearest with ties away from zero (add half of the dropped 13 bits to
    the magnitude, then clear them; the sign bit is apart from the
    magnitude)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores take of a float32 passed as a .tf32 operand:
    its top 19 bits (the low 13 mantissa bits dropped)."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the tensor cores see them: hi rounded, lo = x - hi
    (exact in float32) truncated."""
    hi = tf32(x)
    return hi, tf32_operand(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on the tensor cores: three TF32 passes (the small terms
    first), or one."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero fill past the rows and columns of the last two dims (cp.async's
    zero fill past Tq / Tk, and the columns past D zeroed once)."""
    out = x.new_zeros((*x.shape[:-2], rows, cols))
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def emulate(q, k, v, causal: bool = True, window: int = 0, passes: int = 3,
            probs_bf16: bool = False):
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) float32 -> (B,Hq,Tq,D), as the kernel computes
    (``probs_bf16``: the P V product of bf16(P) and bf16(V), exact products
    summed in float32).

    Also asserts the kernel's tile bookkeeping: the key tiles it skips hold
    no key a real query row sees, and the tiles it does not mask hide none.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dp, bk, _ = instance(d)
    nq, nk = -(-tq // BQ), -(-tk // bk)
    group = hq // hkv
    qf = _pad(q, nq * BQ, dp)
    kf = _pad(k, nk * bk, dp).repeat_interleave(group, dim=1)
    vf = _pad(v, nk * bk, dp).repeat_interleave(group, dim=1)
    scale_log2 = float(np.float32(math.log2(math.e) / math.sqrt(d)))
    off = tk - tq
    out = torch.empty((b, hq, nq * BQ, dp))
    for qt in range(nq):
        q0 = qt * BQ
        q_first, q_last = q0 + off, min(q0 + BQ, tq) - 1 + off
        khi = min(tk, q_last + 1) if causal else tk
        klo = max(0, q_first - window + 1) if window > 0 else 0
        kt0, kt1 = klo // bk, -(-khi // bk)
        qpos = torch.arange(q0, q0 + BQ)[:, None] + off
        real = (torch.arange(q0, q0 + BQ) < tq)[:, None]
        qtile = qf[:, :, q0:q0 + BQ]
        m = torch.full((b, hq, BQ, 1), -math.inf)
        l = torch.zeros((b, hq, BQ, 1))
        o = torch.zeros((b, hq, BQ, dp))
        for kt in range(nk):
            k0 = kt * bk
            kpos = torch.arange(k0, k0 + bk)[None, :]
            seen = (kpos < tk).expand(BQ, bk)
            if causal:
                seen = seen & (kpos <= qpos)
            if window > 0:
                seen = seen & (kpos > qpos - window)
            if not kt0 <= kt < kt1:
                assert not (seen & real).any(), f"skipped key tile {kt} of query tile {qt}"
                continue
            s = product(qtile, kf[:, :, k0:k0 + bk].transpose(-1, -2), passes)
            edge = (k0 + bk > tk or (causal and k0 + bk - 1 > q_first)
                    or (window > 0 and k0 <= q_last - window))
            if edge:
                s = torch.where(seen, s, -math.inf)
            else:
                assert seen[real[:, 0]].all(), f"unmasked tile {kt} hides a key"
            # the running max in scaled units; p = 2^(s c - m_ref), one FMA in the kernel
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
            m_ref = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_ref)
            p = torch.where(s == -math.inf, 0.0, torch.exp2(s * scale_log2 - m_ref))
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
            if probs_bf16:
                pv = p.bfloat16().float() @ vf[:, :, k0:k0 + bk].bfloat16().float()
            else:
                pv = product(p, vf[:, :, k0:k0 + bk], passes)
            o = o * alpha + pv
        out[:, :, q0:q0 + BQ] = o / l.clamp_min(1e-30)
    return out[:, :, :tq, :d]


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


def _close(got, want) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol = rtol = 3e-5)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= TOL + TOL * want.abs()).all())


CASES = [
    (1, 4, 2, 200, 200, 16, True, 0),       # the reduced configurations' head dim, GQA
    (1, 2, 1, 150, 150, 128, True, 0),      # the kernel-phase head dim, ragged last tiles
    (1, 2, 2, 300, 300, 128, True, 100),    # window across a 64-key tile edge
    (2, 2, 1, 1, 260, 64, True, 0),         # Tq = 1, suffix-aligned
    (1, 2, 1, 70, 333, 128, False, 0),      # non-causal, ragged Tk, Tq < Tk
    (1, 2, 2, 100, 100, 72, True, 0),       # D = 72 in the 128 instance: zero columns
    (1, 4, 2, 190, 190, 256, True, 70),     # D = 256: 32-key tiles, two warps a row block
    (1, 2, 1, 140, 140, 320, True, 40),     # D = 320 with a window
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", CASES)
def test_emulated_kernel_vs_oracle_and_plain(b, hq, hkv, tq, tk, d, causal, window):
    q, k, v = _inputs(b * 1000 + tq + tk + d, b, hq, hkv, tq, tk, d)
    got = emulate(q, k, v, causal=causal, window=window)
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == plain.shape == (b, hq, tq, d) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    oracle = np.array(jref.flash_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                                 causal=causal, window=window))
    for want, name in ((plain, "flash_attention_plain"),
                       (torch.from_numpy(oracle), "ref.flash_attention_ref")):
        err, ok = _close(got, want)
        assert ok, f"emulated kernel vs {name}: max |difference| {err}"


# the Pallas kernel keeps padded keys in a non-causal call whose Tk is not a
# multiple of its key block, so these are causal or whole blocks
PALLAS_CASES = [(1, 4, 2, 128, 128, 16, True, 0), (1, 2, 1, 96, 160, 128, False, 0),
                (1, 2, 2, 128, 128, 320, True, 48)]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", PALLAS_CASES)
def test_emulated_kernel_vs_pallas(b, hq, hkv, tq, tk, d, causal, window):
    q, k, v = _inputs(b * 77 + tq + tk + d, b, hq, hkv, tq, tk, d)
    got = emulate(q, k, v, causal=causal, window=window)
    pallas = np.array(jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                            causal=causal, window=window, block_q=32,
                                            block_k=32))
    err, ok = _close(got, torch.from_numpy(pallas))
    assert ok, f"emulated kernel vs the Pallas kernel (interpret mode): max |difference| {err}"


def test_one_tf32_pass_breaks_the_gate():
    """Why the kernel splits its operands: one TF32 pass (11 bits of each
    operand) moves outputs past the float32 gate; three passes hold it."""
    q, k, v = _inputs(7, 1, 4, 2, 200, 200, 128)
    plain = tfa.flash_attention_plain(q, k, v, causal=True)
    assert _close(emulate(q, k, v, causal=True), plain)[1]
    err, ok = _close(emulate(q, k, v, causal=True, passes=1), plain)
    assert not ok and err > 10 * TOL, err


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", [
    (1, 4, 4, 150, 150, 24, True, 0),       # reduced deepseek-v3's MLA call (V padded)
    (1, 2, 1, 200, 200, 128, True, 60)])    # a window
def test_emulated_probs_bf16_vs_plain(b, hq, hkv, tq, tk, d, causal, window):
    q, k, v = _inputs(b * 31 + tq + d, b, hq, hkv, tq, tk, d)
    if d == 24:
        v[..., 16:] = 0.0
    got = emulate(q, k, v, causal=causal, window=window, probs_bf16=True)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window, probs_bf16=True)
    weighted = tfa.flash_attention_plain(q, k, v.abs(), causal=causal, window=window)
    diff = (got - want).abs()
    assert bool((diff <= TOL + TOL * want.abs() + PROBS_BF16_RTOL * weighted).all()), \
        float(diff.max())
    # the flag is not the 3xTF32 function: the float32 gate alone breaks
    assert not _close(got, tfa.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window))[1]


def test_tf32_rounds_to_nearest_ties_away():
    one, ulp = 1.0, 2.0 ** -10                  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -20,
                      one + 3 * ulp / 2, 3.0, 0.0, 1e-30])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    got = tf32(x)
    assert torch.equal(got[:6], want)
    assert abs(float(got[6]) - 1e-30) <= 1e-30 * 2.0 ** -11
    assert torch.equal(tf32_operand(torch.tensor([one + ulp - 2.0 ** -20, -(one + ulp / 2)])),
                       torch.tensor([one, -one]))
    x = torch.tensor([math.pi])
    hi, lo = split(x)
    assert float(hi) != float(x) and float((hi + lo - x).abs()) <= float(x) * 2.0 ** -21


def test_instances_cover_every_head_dim():
    """Every head dim the wrapper takes has an instance whose shared
    memory fits a block, and whose O columns split evenly into 8-column
    blocks per warp."""
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        dp, bk, split2 = instance(d)
        assert d <= dp and dp % 16 == 0 and bk in (32, 64)
        assert smem_bytes(dp, bk) <= SMEM_LIMIT
        assert (dp // (2 if split2 else 1)) % 8 == 0


def test_shared_memory_pitches_are_conflict_free():
    """The lanes of a warp load distinct banks: Q and K 128-bit loads at
    (rows g and g + 8, columns 4t .. 4t + 3), 8 lanes a phase; V 32-bit
    loads at (rows 2t and 2t + 1, column g)."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for dp, _, _ in INSTANCES:
        lk, lv = pitches(dp)
        for row0 in (0, 8):
            for phase in range(4):
                ln = lanes[8 * phase:8 * phase + 8]
                words = ((g[ln] + row0) * lk + 4 * t[ln])[:, None] + np.arange(4)
                assert len(set((words % 32).ravel())) == 32
        for row in (2 * t, 2 * t + 1):
            assert len(set((row * lv + g) % 32)) == 32


def main() -> None:
    for case in CASES:
        b, hq, hkv, tq, tk, d, causal, window = case
        q, k, v = _inputs(b * 1000 + tq + tk + d, b, hq, hkv, tq, tk, d)
        plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        errs = [_close(emulate(q, k, v, causal, window, passes=n), plain) for n in (3, 1)]
        print(f"{case}: max |emulated - plain| with 3xTF32 {errs[0][0]:.6g} "
              f"(gate {'held' if errs[0][1] else 'broken'}), one TF32 pass "
              f"{errs[1][0]:.6g} (gate {'held' if errs[1][1] else 'broken'})")


if __name__ == "__main__":
    main()
