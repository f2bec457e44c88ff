"""Public kernel API with implementation dispatch (PyTorch port).

Every op of the slice comes in two implementations:

  impl="torch"  the plain PyTorch version: the counterpart of the JAX
                package's ``jnp`` path, on any device (bit for bit for
                the integer ops; attention within a float tolerance)
  impl="cuda"   the hand-written CUDA kernel (CUDA tensors only)

``impl="auto"`` picks the kernel for CUDA tensors and the plain version
for CPU tensors.  Containers and the model call through this module
only.  Integer arguments are normalised to the int32 words the kernels
take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import binning, bloom_kernel, hash_probe, ssm_scan
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import (FREE, READY, STATE_MASK, bucket_state,  # noqa: F401
                                     MODE_SET, MODE_ADD, MODE_KEEP, bloom_find_ref)

_I32 = torch.int32

IMPLS = ("auto", "torch", "cuda")


def resolve(impl: str, t: torch.Tensor) -> str:
    """``"torch"`` or ``"cuda"`` for an op on tensors on ``t``'s device."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS})")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' launches CUDA kernels and needs CUDA "
                         f"tensors, got a tensor on {t.device}")
    return impl


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd would record an op on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def refuse_grad(what: str, item: str, *ts: torch.Tensor) -> None:
    """Raise where a kernel route without a backward would cut the gradient
    of ``ts`` (its output would carry no ``grad_fn``)."""
    if needs_grad(*ts):
        raise NotImplementedError(
            f"{what} has no backward on the card yet (ROADMAP Queue 1 item {item}); "
            "call it under torch.no_grad() or with impl='torch'")


def _w(t: torch.Tensor) -> torch.Tensor:
    """Contiguous int32 words (u32 values keep their bits)."""
    if t.dtype == torch.uint32:
        t = t.view(_I32)
    return t.to(_I32).contiguous()


def _b(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bool).contiguous()


# --------------------------------------------------------------------------
# binning + exchange send-buffer construction
# --------------------------------------------------------------------------

def bin_offsets(bins, nbins: int, valid=None, impl: str = "auto"):
    """Per-bin valid counts + stable within-bin offsets.

    Returns ``(counts (nbins,), offsets (N,))``; offsets of invalid items
    are unspecified (the JAX package's jnp path and Pallas kernel differ
    there; both of the port's versions give the rank among the invalid).
    """
    if valid is None:
        valid = torch.ones(bins.shape[0], dtype=torch.bool, device=bins.device)
    if resolve(impl, bins) == "torch":
        return binning.bin_offsets_plain(bins, nbins, valid)
    return binning.bin_offsets(_w(bins), nbins, _b(valid))


def multi_bin_offsets(bins, flow, nbins: int, nflows: int, valid=None,
                      impl: str = "auto"):
    """Segmented multi-flow slot assignment (the ExchangePlan hot path).

    ONE :func:`bin_offsets` pass over the composite key
    ``dest * nflows + flow``; returns ``(counts (nbins, nflows), offsets)``.
    """
    comp = bins.to(_I32) * nflows + flow.to(_I32)
    counts, offs = bin_offsets(comp, nbins * nflows, valid, impl=impl)
    return counts.reshape(nbins, nflows), offs


def bin_histogram(bins, nbins: int, valid=None, impl: str = "auto"):
    """Per-bin valid counts, (nbins,) int32; bins outside ``[0, nbins)``
    are not counted."""
    if valid is None:
        valid = torch.ones(bins.shape[0], dtype=torch.bool, device=bins.device)
    if resolve(impl, bins) == "torch":
        return binning.histogram_plain(bins, nbins, valid)
    return binning.histogram(_w(bins), nbins, _b(valid))


def ragged_slots(bins, flow, offsets, valid, rnd: int, word_off, row_words,
                 caps, rounds, wtot: int, sentinel: int, impl: str = "auto"):
    """Ragged fused-wire word slots for retry round ``rnd``.

    Item i of flow f starts at ``bins[i]*wtot + word_off[f] + (offsets[i]
    - rnd*caps[f]) * row_words[f]`` iff its rank falls in the round's
    window ``[rnd*C_f, (rnd+1)*C_f)`` and ``rounds[f] > rnd``; every other
    item gets ``sentinel``.  The transports use :func:`pack_rows`, which
    fuses this with the row scatter.
    """
    if resolve(impl, bins) == "torch":
        return binning.ragged_slots_plain(bins, flow, offsets, valid, rnd, word_off,
                                          row_words, caps, rounds, wtot, sentinel)
    return binning.ragged_slots(_w(bins), _w(flow), _w(offsets), _b(valid), rnd,
                                _w(word_off), _w(row_words), _w(caps), _w(rounds),
                                wtot, sentinel)


def stage_slots(bins, flow, offsets, valid, word_off, row_words, caps, live,
                wtot: int, sentinel: int, impl: str = "auto"):
    """Per-hop ragged word slots (the hierarchical transport's stage form):
    :func:`ragged_slots` at round 0 with the per-flow live mask as the
    rounds, so item i of flow f gets ``bins[i]*wtot + word_off[f] +
    offsets[i]*row_words[f]`` iff it is valid, its stage rank is below
    ``caps[f]`` and ``live[f]``; every other item gets ``sentinel``."""
    return ragged_slots(bins, flow, offsets, valid, 0, word_off, row_words, caps, live,
                        wtot, sentinel, impl=impl)


def pack_rows(rows, bins, flow, offsets, valid, rnd: int, word_off, row_words,
              caps, rounds, wtot: int, total: int, impl: str = "auto"):
    """Fused ragged wire pack: slots + row scatter in one pass."""
    if resolve(impl, rows) == "torch":
        return binning.pack_rows_plain(rows, bins, flow, offsets, valid, rnd,
                                       word_off, row_words, caps, rounds, wtot, total)
    return binning.pack_rows(_w(rows), _w(bins), _w(flow), _w(offsets), _b(valid),
                             rnd, _w(word_off), _w(row_words), _w(caps), _w(rounds),
                             wtot, total)


def place_rows(dst, slots, rows, impl: str = "auto"):
    """A copy of ``dst`` with (N, W) rows written at word ``slots``;
    words at or past ``dst.numel()`` drop."""
    if rows.ndim == 1:
        rows = rows[:, None]
    if resolve(impl, dst) == "torch":
        return binning.place_rows_plain(dst, slots, rows)
    return binning.place_rows(_w(dst), _w(slots), _w(rows))


# --------------------------------------------------------------------------
# wire integrity: per-row mixing hash
# --------------------------------------------------------------------------

def mix_rows(rows, impl: str = "auto") -> torch.Tensor:
    """Per-row u32 mixing hash of an (N, L) word matrix (wire checksums).

    Lane ``l`` is weighted by ``0x9E3779B1 * (2l + 1)`` (mod 2**32); the
    weighted sum is finished with fmix32, all in wrapping u32 arithmetic,
    so sender and owner agree bit for bit.  An all-zero row hashes to 0,
    so summing hashes over a wire window skips empty slots.  Returns (N,)
    int32 words.
    """
    if rows.ndim == 1:
        rows = rows[:, None]
    if rows.dtype == torch.uint32:
        rows = rows.view(_I32)
    if resolve(impl, rows) == "torch":
        return binning.row_mix_plain(rows)
    rows = rows.to(_I32)
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    return binning.row_mix(rows)


# --------------------------------------------------------------------------
# blocked hash table
# --------------------------------------------------------------------------

def bulk_insert(tkeys, tvals, status, qblock, qkeys, qvals, qvalid,
                mode: int = MODE_SET, impl: str = "auto"):
    """Insert a batch of column arrays; see ``ref.hash_probe_insert_ref``.

    Returns (tkeys, tvals, status, success(M,)).
    """
    args = (tkeys, tvals, status, _w(qblock), _w(qkeys), _w(qvals), _b(qvalid), mode)
    if resolve(impl, tkeys) == "torch":
        return hash_probe.insert_plain(*args)
    return hash_probe.insert(*args)


def bulk_find(tkeys, tvals, status, qblock, qkeys, qvalid, impl: str = "auto"):
    """Batch find of column arrays; returns (found(M,), values(M, Lv))."""
    args = (tkeys, tvals, status, _w(qblock), _w(qkeys), _b(qvalid))
    if resolve(impl, tkeys) == "torch":
        return hash_probe.find_plain(*args)
    return hash_probe.find(*args)


def bulk_insert_arrivals(tkeys, tvals, status, seg, valid, mode: int = MODE_SET,
                         impl: str = "auto"):
    """Batch insert off the (M, 1+Lk+Lv) arrival segment
    [local block | key lanes | value lanes].

    Returns (tkeys, tvals, status, success(M,)).
    """
    if resolve(impl, tkeys) == "torch":
        return hash_probe.insert_arrivals_plain(tkeys, tvals, status, seg, valid, mode)
    return hash_probe.insert_arrivals(tkeys, tvals, status, seg, _b(valid), mode)


def bulk_find_arrivals(tkeys, tvals, status, seg, valid, impl: str = "auto"):
    """Batch find off the (M, 1+Lk) arrival segment; returns
    (found(M,), values(M, Lv))."""
    if resolve(impl, tkeys) == "torch":
        return hash_probe.find_arrivals_plain(tkeys, tvals, status, seg, valid)
    return hash_probe.find_arrivals(tkeys, tvals, status, seg, _b(valid))


# --------------------------------------------------------------------------
# blocked Bloom filter
# --------------------------------------------------------------------------

def seg_exclusive_or_scan(words: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Exclusive segmented bitwise-OR scan over rows (segments contiguous).

    words: (M, L) int32 words; seg_start: (M,) bool marking segment heads.
    Row i receives the OR of earlier rows in its segment (0 at heads).
    Plain PyTorch on every device, as the JAX package computes it with
    ``lax.associative_scan`` outside any kernel: a log-step
    (Hillis-Steele) segmented scan.
    """
    m = words.shape[0]
    incl, flag = words.clone(), seg_start.clone()
    d = 1
    while d < m:
        # rows i >= d combine with row i - d unless a head lies in (i-d, i]
        take = ~flag[d:]
        incl[d:] = torch.where(take[:, None], incl[d:] | incl[:-d], incl[d:])
        flag[d:] = flag[d:] | flag[:-d]
        d *= 2
    out = torch.zeros_like(words)
    if m > 1:
        out[1:] = incl[:-1]
    return torch.where(seg_start[:, None], 0, out)


def hash_words(lanes, k: int, impl: str = "auto") -> torch.Tensor:
    """(M, L) u32 item lanes -> (M, 2) Bloom block words with k bits set
    (``bloom_words_ref(double_hash(lanes, k, 64), k)``)."""
    if resolve(impl, lanes) == "torch":
        return bloom_kernel.hash_words_plain(lanes, k)
    return bloom_kernel.hash_words(_w(lanes), k)


def bloom_insert(filter_words, qblock, qwords, qvalid, impl: str = "auto"):
    """Batch blocked-Bloom insert with first-inserter-wins atomicity
    (``repro/kernels/ops.py:231-266``).

    A stable sort by block, an exclusive OR-scan per block segment gives
    each item the bits its earlier batch-mates set; ``membership`` (the
    kernel on CUDA tensors) tests each item against them; each segment's
    last row writes the block's new word.  Returns (filter_words,
    already_present(M,)); the filter is a new tensor.
    """
    kind = resolve(impl, filter_words)
    nb = filter_words.shape[0]
    m = qblock.shape[0]
    qvalid = _b(qvalid)
    b = torch.where(qvalid, _w(qblock), nb)
    order = torch.argsort(b, stable=True)
    sb, sw, svalid = b[order], _w(qwords)[order], qvalid[order]

    change = sb[1:] != sb[:-1]
    seg_start = torch.cat([torch.ones(min(m, 1), dtype=torch.bool, device=sb.device),
                           change])
    own = torch.where(svalid[:, None], sw, 0)
    ex_or = seg_exclusive_or_scan(own, seg_start)

    sb_c = sb.clamp(0, nb - 1).to(torch.int64)
    base = filter_words[sb_c]
    prior = base | ex_or
    if kind == "torch":
        already = bloom_kernel.membership_plain(prior, sw, svalid)
    else:
        already = bloom_kernel.membership(prior, sw, svalid)

    # the inclusive OR of each segment lands on its last row
    is_last = torch.cat([change, torch.ones(min(m, 1), dtype=torch.bool, device=sb.device)])
    keep = is_last & (sb < nb)
    out_words = filter_words.clone()
    out_words[sb_c[keep]] = (base | ex_or | own)[keep]

    out = torch.zeros(m, dtype=torch.bool, device=sb.device)
    out[order] = already
    return out_words, out


def bloom_find(filter_words, qblock, qwords, qvalid, impl: str = "auto"):
    """Membership query of block words; (M,) bool.  Plain on every device:
    the JAX package has no kernel for it (``ops.py:269-270``)."""
    resolve(impl, filter_words)
    return bloom_find_ref(filter_words, _w(qblock), _w(qwords), _b(qvalid))


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

def flash_attention(q, k, v, causal: bool = True, window: int = 0, impl: str = "auto",
                    probs_bf16: bool = False):
    """q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D) -> (B,Hq,Tq,D): suffix-aligned
    causal / sliding-window GQA attention, ``probs_bf16`` rounding P and V
    to bf16 for P V (see ``kernels/flash_attention``).

    On the card a call that needs a gradient goes through
    ``FlashAttentionFn`` (the forward kernel, and the backward kernel as its
    gradient); one that needs none launches the forward alone.  The plain
    version is differentiated by autograd."""
    if resolve(impl, q) == "torch":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         probs_bf16=probs_bf16)
    if needs_grad(q, k, v):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window, probs_bf16)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, probs_bf16=probs_bf16)


# --------------------------------------------------------------------------
# recurrent mixers' scans
# --------------------------------------------------------------------------

def mamba_scan(x, dt, b, c, a, h0, impl: str = "auto"):
    """Mamba2's recurrence over T: x (B,T,H,P), dt (B,T,H), b/c (B,T,S),
    a (H,), h0 (B,H,S,P), float32 -> (y (B,T,H,P), final state)."""
    if resolve(impl, x) == "torch":
        return ssm_scan.mamba_scan_plain(x, dt, b, c, a, h0)
    refuse_grad("mamba_scan", "7c", x, dt, b, c, a, h0)
    return ssm_scan.mamba_scan(x, dt, b, c, a, h0)


def rwkv_scan(r, k, v, w, u, s0, impl: str = "auto"):
    """RWKV-6's recurrence over T: r/k/v/w (B,T,H,K), u (H,K), s0
    (B,H,K,K), float32 -> (out (B,T,H,K), final state)."""
    if resolve(impl, r) == "torch":
        return ssm_scan.rwkv_scan_plain(r, k, v, w, u, s0)
    refuse_grad("rwkv_scan", "7c", r, k, v, w, u, s0)
    return ssm_scan.rwkv_scan(r, k, v, w, u, s0)
