"""Public kernel API with implementation dispatch (PyTorch port).

Every op of the slice comes in two implementations:

  impl="torch"  the plain PyTorch version: the counterpart of the JAX
                package's ``jnp`` path, bit for bit, on any device
  impl="cuda"   the hand-written CUDA kernel (CUDA tensors only)

``impl="auto"`` picks the kernel for CUDA tensors and the plain version
for CPU tensors.  Containers call through this module only.  Integer
arguments are normalised to the int32 words the kernels take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import binning, hash_probe
from repro_torch.kernels.ref import (FREE, READY, STATE_MASK, bucket_state,  # noqa: F401
                                     MODE_SET, MODE_ADD, MODE_KEEP,
                                     hash_probe_find_ref)

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


def ragged_slots(bins, flow, offsets, valid, rnd: int, word_off, row_words,
                 caps, rounds, wtot: int, sentinel: int) -> torch.Tensor:
    """Ragged fused-wire word slots for retry round ``rnd`` (plain only:
    the transports use :func:`pack_rows`, which fuses it)."""
    return binning.ragged_slots_plain(bins, flow, offsets, valid, rnd, word_off,
                                      row_words, caps, rounds, wtot, sentinel)


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
# blocked hash table
# --------------------------------------------------------------------------

def _column_front_end(what: str):
    return NotImplementedError(
        f"{what} with CUDA tensors: the column front end (Pallas "
        "hash_probe.insert/find) is not ported yet, ROADMAP.md Queue 2; "
        "the exchange path uses bulk_insert_arrivals/bulk_find_arrivals")


def bulk_insert(tkeys, tvals, status, qblock, qkeys, qvals, qvalid,
                mode: int = MODE_SET, impl: str = "auto"):
    """Insert a batch of column arrays; see ``ref.hash_probe_insert_ref``.

    Returns (tkeys, tvals, status, success(M,)).
    """
    if resolve(impl, tkeys) == "cuda":
        raise _column_front_end("bulk_insert")
    return hash_probe.bulk_insert_plain(tkeys, tvals, status, _w(qblock), _w(qkeys),
                                        _w(qvals), _b(qvalid), mode)


def bulk_find(tkeys, tvals, status, qblock, qkeys, qvalid, impl: str = "auto"):
    """Batch find of column arrays; returns (found(M,), values(M, Lv))."""
    if resolve(impl, tkeys) == "cuda":
        raise _column_front_end("bulk_find")
    return hash_probe_find_ref(tkeys, tvals, status, _w(qblock), _w(qkeys), _b(qvalid))


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
