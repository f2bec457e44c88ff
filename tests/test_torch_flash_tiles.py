"""The bf16 flash-attention kernel's tile algorithm, emulated in torch on the CPU.

``csrc/flash_attention.cu``'s tensor-core kernel (``flash_fwd_wgmma``)
runs only on the card.  ``emulate`` repeats its arithmetic here, tile by
tile: the instance a head dim picks (query and key tile sizes), the key
tiles a query tile visits, the per-element mask on edge tiles only, the
running max kept in units of the folded multiplier ``c = log2(e) /
sqrt(D)`` and ``p = exp2(s * c - m)``, the bf16 split of P into ``P_hi +
P_lo``, and the zero fill of TMA past Tq, Tk and D.  It
is held against the JAX oracle ``ref.flash_attention_ref`` and against
``flash_attention_plain`` at the card's elementwise bf16 gate,
``|x - want| <= 2**-7 |want| + 1e-4``.  Inputs come from numpy with a
seed.  Without the split (P rounded once to bf16) it is the
``probs_bf16`` instance, held against
``flash_attention_plain(probs_bf16=True)`` at that gate plus ``2**-8`` of
the attention-weighted mean of ``|V|`` (each side rounds each probability
to bf16 against its own running max).  Run as a script, it prints the
largest error against the plain version with the split of P and without
it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RTOL, ATOL = 2.0 ** -7, 1e-4
#: the probs_bf16 allowance, in units of the weighted mean of |V| (two bf16 roundings)
PROBS_BF16_RTOL = 2.0 ** -8

# (head dims up to, query rows a CTA, keys a tile): the kernel's instances
INSTANCES = [(64, 128, 128), (128, 128, 128), (192, 128, 64), (256, 128, 64), (320, 64, 64)]


def instance(d: int) -> tuple[int, int, int]:
    """(padded head dim, query tile, key tile) of the kernel serving ``d``."""
    for max_d, bq, bk in INSTANCES:
        if d <= max_d:
            return max_d, bq, bk
    raise ValueError(d)


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero fill past the rows and columns of the last two dims (TMA's)."""
    out = x.new_zeros((*x.shape[:-2], rows, cols))
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def emulate(q, k, v, causal: bool = True, window: int = 0, split: bool = True):
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) bf16 -> (B,Hq,Tq,D) bf16, as the kernel computes.

    Also asserts the kernel's tile bookkeeping: the key tiles it skips hold
    no key a real query row sees, and the tiles it does not mask hide none.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dp, bq, bk = instance(-(-d // 8) * 8)
    nq, nk = -(-tq // bq), -(-tk // bk)
    group = hq // hkv
    qf = _pad(q.float(), nq * bq, dp)
    kf = _pad(k.float(), nk * bk, dp).repeat_interleave(group, dim=1)
    vf = _pad(v.float(), nk * bk, dp).repeat_interleave(group, dim=1)
    scale_log2 = float(np.float32(math.log2(math.e) / math.sqrt(d)))
    off = tk - tq
    out = torch.empty((b, hq, nq * bq, dp))
    for qt in range(nq):
        q0 = qt * bq
        q_first, q_last = q0 + off, min(q0 + bq, tq) - 1 + off
        khi = min(tk, q_last + 1) if causal else tk
        klo = max(0, q_first - window + 1) if window > 0 else 0
        kt0, kt1 = klo // bk, -(-khi // bk)
        qpos = torch.arange(q0, q0 + bq)[:, None] + off
        real = (torch.arange(q0, q0 + bq) < tq)[:, None]
        qtile = qf[:, :, q0:q0 + bq]
        m = torch.full((b, hq, bq, 1), -math.inf)
        l = torch.zeros((b, hq, bq, 1))
        o = torch.zeros((b, hq, bq, dp))
        for kt in range(nk):
            k0 = kt * bk
            kpos = torch.arange(k0, k0 + bk)[None, :]
            seen = (kpos < tk).expand(bq, bk)
            if causal:
                seen = seen & (kpos <= qpos)
            if window > 0:
                seen = seen & (kpos > qpos - window)
            if not kt0 <= kt < kt1:
                assert not (seen & real).any(), f"skipped key tile {kt} of query tile {qt}"
                continue
            s = qtile @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
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
            vt = vf[:, :, k0:k0 + bk]
            hi = p.bfloat16().float()
            if split:
                o = o * alpha + hi @ vt + (p - hi).bfloat16().float() @ vt
            else:
                o = o * alpha + hi @ vt
        out[:, :, q0:q0 + bq] = o / l.clamp_min(1e-30)
    return out[:, :, :tq, :d].bfloat16()


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


def _oracle(q, k, v, causal, window):
    """The JAX oracle in float32 on the bf16 values, rounded to bf16."""
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    out = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    return torch.from_numpy(np.array(out, np.float32)).bfloat16()


def _err(got, want):
    """(max |got - want|, whether every element is within the bf16 gate)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= ATOL + RTOL * w.abs()).all())


CASES = [
    (1, 4, 2, 200, 200, 16, True, 0),       # GQA, one 64-column box
    (1, 4, 1, 150, 150, 72, True, 0),       # D = 72: two boxes, zero-filled columns
    (1, 2, 2, 300, 300, 128, True, 100),    # window across a 128-key tile edge
    (2, 4, 2, 1, 260, 128, True, 0),        # Tq = 1, suffix-aligned
    (1, 2, 1, 70, 333, 128, False, 0),      # non-causal, ragged Tk, Tq < Tk
    (1, 4, 2, 190, 190, 256, True, 70),     # D = 256: 64-key tiles, window across an edge
    (1, 2, 1, 140, 140, 320, True, 40),     # D = 320: 64 query rows a CTA
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", CASES)
def test_emulated_kernel_vs_oracle_and_plain(b, hq, hkv, tq, tk, d, causal, window):
    q, k, v = _inputs(b * 1000 + tq + tk + d, b, hq, hkv, tq, tk, d)
    got = emulate(q, k, v, causal=causal, window=window)
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == plain.shape == (b, hq, tq, d) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    for want, name in ((plain, "flash_attention_plain"), (_oracle(q, k, v, causal, window),
                                                          "ref.flash_attention_ref")):
        err, ok = _err(got, want)
        assert ok, f"emulated kernel vs {name}: max |difference| {err}"


def test_rounding_p_once_breaks_the_gate():
    """Why the kernel splits P: rounded once to bf16, as the tensor cores
    take it, P moves outputs past one bf16 ulp of the plain version."""
    q, k, v = _inputs(7, 1, 4, 2, 200, 200, 128)
    plain = tfa.flash_attention_plain(q, k, v, causal=True)
    assert _err(emulate(q, k, v, causal=True), plain)[1]
    assert not _err(emulate(q, k, v, causal=True, split=False), plain)[1]


def test_emulated_probs_bf16_vs_plain():
    """deepseek-v3's MLA prefill call in miniature: D = 192 (nope 128 +
    rope 64), V's 128 columns zero-padded to 192, 64-key tiles."""
    q, k, v = _inputs(19, 1, 4, 4, 300, 300, 192)
    v[..., 128:] = 0
    got = emulate(q, k, v, causal=True, split=False).float()
    want = tfa.flash_attention_plain(q, k, v, causal=True, probs_bf16=True).float()
    weighted = tfa.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal=True)
    diff = (got - want).abs()
    assert bool((diff <= ATOL + RTOL * want.abs() + PROBS_BF16_RTOL * weighted).all()), \
        float(diff.max())
    assert not bool(got[..., 128:].any())


def test_instances_cover_every_head_dim():
    """Every head dim the wrapper takes has an instance, at most 64 columns
    of zero fill, and tiles that fill the wgmma shapes."""
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        dp, bq, bk = instance(-(-d // 8) * 8)
        assert d <= dp < d + 64 and bq in (64, 128) and bk in (64, 128)


def main() -> None:
    for case in CASES:
        b, hq, hkv, tq, tk, d, causal, window = case
        q, k, v = _inputs(b * 1000 + tq + tk + d, b, hq, hkv, tq, tk, d)
        plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        errs = [_err(emulate(q, k, v, causal, window, split=s), plain) for s in (True, False)]
        print(f"{case}: max |emulated - plain| with the split of P {errs[0][0]:.6g} "
              f"(gate {'held' if errs[0][1] else 'broken'}), P rounded once "
              f"{errs[1][0]:.6g} (gate {'held' if errs[1][1] else 'broken'})")


if __name__ == "__main__":
    main()
