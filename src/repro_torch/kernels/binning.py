"""Exchange wire kernels: ``bin_offsets``, ``pack_rows``, ``place_rows``.

Each wrapper launches its hand-written CUDA kernel
(``csrc/binning.cu``) on a CUDA tensor and takes its plain PyTorch
version (the ``*_plain`` function beside it) only for a CPU tensor.
The plain versions are bit-identical to the JAX package's jnp paths
(``repro/kernels/ops.py``) and are the yardstick the kernels are held
against.  Every word is a 32-bit int (u32 bit-view).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.object_container import scatter_rows
from repro_torch.kernels.build import Kernel, register

_I32 = torch.int32
_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: bins the CUDA bin_offsets serves (its extra invalid bin makes 1024)
MAX_BINS = 1023
_SEG_ITEMS = 1024

_BIN_OFFSETS = register("bin_offsets", Kernel(
    "binning", "bin_offsets_launch", [_P, _P, _LL, _INT, _P, _P, _P, _P]))
_PACK_ROWS = register("pack_rows", Kernel(
    "binning", "pack_rows_launch",
    [_P, _INT, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _INT, _INT, _LL, _LL, _P]))
_PLACE_ROWS = register("place_rows", Kernel(
    "binning", "place_rows_launch", [_P, _LL, _P, _P, _LL, _INT, _P]))


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


# --------------------------------------------------------------------------
# bin_offsets
# --------------------------------------------------------------------------

def bin_offsets_plain(bins: torch.Tensor, nbins: int, valid=None):
    """Stable-argsort per-bin counts and within-bin ranks (``ops.py:299-310``).

    Returns ``(counts (nbins,) i32, offsets (N,) i32)``; an invalid
    item's offset is its rank among the invalid items.
    """
    n = bins.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=bins.device)
    b = torch.where(valid, bins.to(torch.int64), nbins)
    counts_full = torch.bincount(b, minlength=nbins + 1)
    start = torch.cumsum(counts_full, 0) - counts_full
    order = torch.argsort(b, stable=True)
    pos_sorted = torch.arange(n, device=bins.device) - start[b[order]]
    offsets = torch.empty(n, dtype=_I32, device=bins.device)
    offsets[order] = pos_sorted.to(_I32)
    return counts_full[:nbins].to(_I32), offsets


def bin_offsets(bins: torch.Tensor, nbins: int, valid=None):
    """Per-bin valid counts + each item's stable rank within its bin.

    CUDA: three passes of ``csrc/binning.cu`` (segment counts, scan,
    ordered rank), equal to :func:`bin_offsets_plain` bit for bit,
    invalid items included.  At most :data:`MAX_BINS` bins.
    """
    if not bins.is_cuda:
        return bin_offsets_plain(bins, nbins, valid)
    n = bins.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=bins.device)
    require(bins, "bin_offsets bins", _I32, (n,), bins.device)
    require(valid, "bin_offsets valid", torch.bool, (n,), bins.device)
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"bin_offsets: {nbins} bins; the CUDA kernel serves "
                         f"1..{MAX_BINS}")
    nb = nbins + 1
    nseg = -(-n // _SEG_ITEMS)
    seg_counts = torch.empty(nseg * nb, dtype=_I32, device=bins.device)
    seg_base = torch.empty_like(seg_counts)
    counts = torch.empty(nb, dtype=_I32, device=bins.device)
    offsets = torch.empty(n, dtype=_I32, device=bins.device)
    _BIN_OFFSETS(bins, valid, n, nb, seg_counts, seg_base,
                 counts, offsets)
    return counts[:nbins], offsets


# --------------------------------------------------------------------------
# pack_rows
# --------------------------------------------------------------------------

def ragged_slots_plain(bins, flow, offsets, valid, rnd: int, word_off, row_words,
                       caps, rounds, wtot: int, sentinel: int) -> torch.Tensor:
    """Ragged fused-wire word slot of each item for retry round ``rnd``.

    Item i of flow f starts at ``bins*wtot + word_off[f] + (offsets -
    rnd*caps[f]) * row_words[f]`` iff its rank falls in the round's
    window ``[rnd*C_f, (rnd+1)*C_f)`` and ``rounds[f] > rnd``; every
    other item gets ``sentinel`` (``ops.py:358-364``).
    """
    f = flow.to(torch.int64)
    cap = caps[f].to(torch.int64)
    off_r = offsets.to(torch.int64) - rnd * cap
    in_r = valid & (rounds[f] > rnd) & (off_r >= 0) & (off_r < cap)
    slot = (bins.to(torch.int64) * wtot + word_off[f].to(torch.int64)
            + off_r * row_words[f].to(torch.int64))
    return torch.where(in_r, slot, sentinel).to(_I32)


def pack_rows_plain(rows, bins, flow, offsets, valid, rnd: int, word_off,
                    row_words, caps, rounds, wtot: int, total: int) -> torch.Tensor:
    """Slots, then a row scatter into a zeroed ``(total,)`` buffer (``ops.py:406-410``)."""
    slots = ragged_slots_plain(bins, flow, offsets, valid, rnd, word_off, row_words,
                               caps, rounds, wtot, total)
    return scatter_rows(torch.zeros(total, dtype=_I32, device=rows.device), slots,
                        rows, widths=row_words[flow.to(torch.int64)])


def pack_rows(rows, bins, flow, offsets, valid, rnd: int, word_off, row_words,
              caps, rounds, wtot: int, total: int) -> torch.Tensor:
    """Fused ragged wire pack: the ``(total,)`` send buffer for round ``rnd``.

    ``rows`` is the (N, wmax) right-padded row matrix (flow ``f`` uses its
    first ``row_words[f]`` lanes); words nobody writes are 0.
    """
    if not rows.is_cuda:
        return pack_rows_plain(rows, bins, flow, offsets, valid, rnd, word_off,
                               row_words, caps, rounds, wtot, total)
    n, wmax = rows.shape
    nflows = word_off.shape[0]
    dev = rows.device
    require(rows, "pack_rows rows", _I32, (n, wmax), dev)
    for t, name in ((bins, "bins"), (flow, "flow"), (offsets, "offsets")):
        require(t, f"pack_rows {name}", _I32, (n,), dev)
    require(valid, "pack_rows valid", torch.bool, (n,), dev)
    for t, name in ((word_off, "word_off"), (row_words, "row_words"),
                    (caps, "caps"), (rounds, "rounds")):
        require(t, f"pack_rows {name}", _I32, (nflows,), dev)
    if total >= 1 << 31:
        raise ValueError(f"pack_rows: {total} words exceed int32 slots")
    out = torch.empty(total, dtype=_I32, device=dev)
    _PACK_ROWS(rows, wmax, bins, flow, offsets, valid, n,
               word_off, row_words, caps, rounds, nflows, rnd,
               wtot, total, out)
    return out


# --------------------------------------------------------------------------
# place_rows
# --------------------------------------------------------------------------

def place_rows_plain(dst: torch.Tensor, slots: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``scatter_rows(dst, slots, rows)``: a copy of ``dst`` with rows placed."""
    return scatter_rows(dst, slots, rows)


def place_rows(dst: torch.Tensor, slots: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with (N, W) rows written at word ``slots``.

    Words at or past ``dst.numel()`` drop, as in
    ``object_container.scatter_rows``.
    """
    if not dst.is_cuda:
        return place_rows_plain(dst, slots, rows)
    (total,) = dst.shape
    m, w = rows.shape
    require(dst, "place_rows dst", _I32, (total,), dst.device)
    require(slots, "place_rows slots", _I32, (m,), dst.device)
    require(rows, "place_rows rows", _I32, (m, w), dst.device)
    out = torch.empty_like(dst)
    _PLACE_ROWS(dst, total, slots, rows, m, w, out)
    return out
