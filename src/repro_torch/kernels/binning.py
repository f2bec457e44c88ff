"""Exchange wire kernels: ``bin_offsets`` (and ``bin_csr``), ``pack_rows``,
``place_rows``, ``ragged_slots``, ``row_mix`` and ``histogram``.

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

from repro_torch.core.hashing import fmix32
from repro_torch.core.object_container import scatter_rows
from repro_torch.core.u32 import M32, as_u64, mul32, to_i32
from repro_torch.kernels.build import Kernel, library, register

_I32 = torch.int32
_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: bins one launch of the CUDA bin_offsets kernel serves (its extra invalid
#: bin makes ``kMaxBins`` = 1024); more bins go through :func:`bin_csr`
LAUNCH_BINS = 1023
#: bits of the bin one bin_csr pass sorts by (``kDigitBits``)
DIGIT_BITS = 10
_TILE_ITEMS = 4096                       # items per bin_offsets CTA (``kTileItems``)

_BIN_OFFSETS = register("bin_offsets", Kernel(
    "binning", "bin_offsets_launch", [_P, _P, _LL, _INT, _P, _P, _P]))
_BIN_CSR = register("bin_csr", Kernel(
    "binning", "bin_csr_launch", [_P, _LL, _P, _LL, _LL, _P, _P, _P]))
_PACK_ROWS = register("pack_rows", Kernel(
    "binning", "pack_rows_launch",
    [_P, _INT, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _INT, _INT, _LL, _LL, _P]))
_PLACE_ROWS = register("place_rows", Kernel(
    "binning", "place_rows_launch", [_P, _LL, _P, _P, _LL, _INT, _P]))
_RAGGED_SLOTS = register("ragged_slots", Kernel(
    "binning", "ragged_slots_launch",
    [_P, _P, _P, _P, _LL, _P, _P, _P, _P, _INT, _INT, _LL, _LL, _P]))
_ROW_MIX = register("row_mix", Kernel(
    "binning", "row_mix_launch", [_P, _LL, _LL, _INT, _P]))
_HISTOGRAM = register("histogram", Kernel(
    "binning", "histogram_launch", [_P, _P, _LL, _INT, _P]))

#: the per-lane weight of the wire checksum hash is ``_MIX * (2l + 1)``
_MIX = 0x9E3779B1


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


def digit_widths(nbins: int) -> list:
    """Bits of the bin each bin_csr pass sorts by, least significant first:
    the bin's bits split as evenly as :data:`DIGIT_BITS` allows."""
    bits = max(1, (nbins - 1).bit_length())
    passes = -(-bits // DIGIT_BITS)
    return [bits // passes + (p < bits % passes) for p in range(passes)]


def bin_csr_plain(bins: torch.Tensor, nbins: int, valid: torch.Tensor):
    """The items in stable bin order and each bin's start:
    ``(order (N,) i32, start (nbins + 1,) i32)``.

    ``order[start[b]:start[b+1]]`` are bin b's valid items in batch
    order; the items that are not live (invalid, or a bin outside
    ``[0, nbins)``) follow from ``start[nbins]`` on, in batch order.
    A stable argsort.
    """
    live = valid & (bins >= 0) & (bins < nbins)
    key = torch.where(live, bins.to(torch.int64), nbins)
    order = torch.argsort(key, stable=True)
    start = torch.searchsorted(key[order], torch.arange(nbins + 1, device=bins.device))
    return order.to(_I32), start.to(_I32)


def _csr_scratch_bytes(n: int, nbins: int) -> int:
    """Bytes of scratch one ``bin_csr`` launch takes (its C layout's own count)."""
    fn = library(_BIN_CSR.source).bin_csr_scratch_bytes
    fn.argtypes = [_LL, _LL]
    fn.restype = _LL
    return fn(n, nbins)


def bin_csr(bins: torch.Tensor, nbins: int, valid: torch.Tensor):
    """:func:`bin_csr_plain` for any ``nbins``, bit for bit (on the card:
    fewer than 2**30 items).

    CUDA: ``bin_csr`` in ``csrc/binning.cu``, a stable counting sort by
    least-significant digit (:func:`digit_widths`): one memset, one count
    pass over every digit, one launch per digit (tiles ranked in order,
    each digit's prefix across tiles by a decoupled look-back) and one
    pass writing the starts.  ``bins`` may be a strided column (the
    exchange segment's block lane).
    """
    if not bins.is_cuda:
        return bin_csr_plain(bins, nbins, valid)
    n = bins.shape[0]
    dev = bins.device
    if bins.dtype != _I32 or bins.ndim != 1:
        raise ValueError(f"bin_csr bins: want an int32 vector, got {bins.dtype} "
                         f"{tuple(bins.shape)}")
    require(valid, "bin_csr valid", torch.bool, (n,), dev)
    if not 1 <= nbins < 1 << 31 or n >= 1 << 30:
        raise ValueError(f"bin_csr: {n} items into {nbins} bins (fewer than 2**30 items, "
                         f"1 to 2**31 - 1 bins)")
    scratch = torch.empty(-(-_csr_scratch_bytes(n, nbins) // 8), dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=_I32, device=dev)
    start = torch.empty(nbins + 1, dtype=_I32, device=dev)
    _BIN_CSR(bins, bins.stride(0) if n else 1, valid, n, nbins, scratch, order, start)
    return order, start


def bin_offsets_lsd(bins: torch.Tensor, nbins: int, valid: torch.Tensor, csr=None):
    """:func:`bin_offsets_plain`'s counts and ranks for any ``nbins``, read
    off the CSR (``csr``, :func:`bin_csr` by default): a bin's count is
    the width of its run, an item's rank its place less the run's start."""
    order, start = (csr or bin_csr)(bins, nbins, valid)
    start = start.to(torch.int64)
    n = bins.shape[0]
    place = torch.arange(n, dtype=torch.int64, device=bins.device)
    sbin = torch.searchsorted(start[1:], place, right=True)    # each place's bin
    offsets = torch.empty(n, dtype=_I32, device=bins.device).scatter_(
        0, order.to(torch.int64), (place - start[sbin]).to(_I32))
    return (start[1:] - start[:-1]).to(_I32), offsets


def bin_offsets(bins: torch.Tensor, nbins: int, valid=None):
    """Per-bin valid counts + each item's stable rank within its bin.

    CUDA: up to :data:`LAUNCH_BINS` bins, one pass of ``csrc/binning.cu``
    over tiles of 4096 items, each tile's per-bin prefix from the tiles
    before it by a decoupled look-back (one memset, one launch); more bins
    through :func:`bin_offsets_lsd` over :func:`bin_csr`.  Equal to
    :func:`bin_offsets_plain` bit for bit, invalid items included.
    """
    if not bins.is_cuda:
        return bin_offsets_plain(bins, nbins, valid)
    n = bins.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=bins.device)
    require(bins, "bin_offsets bins", _I32, (n,), bins.device)
    require(valid, "bin_offsets valid", torch.bool, (n,), bins.device)
    if nbins < 1:
        raise ValueError(f"bin_offsets: {nbins} bins")
    if nbins > LAUNCH_BINS:
        return bin_offsets_lsd(bins, nbins, valid)
    nb = nbins + 1
    # the tile counter, then each tile's status words
    scratch = torch.empty(1 + -(-n // _TILE_ITEMS) * nb, dtype=torch.int64, device=bins.device)
    counts = torch.empty(nb, dtype=_I32, device=bins.device)
    offsets = torch.empty(n, dtype=_I32, device=bins.device)
    _BIN_OFFSETS(bins, valid, n, nb, scratch, counts, offsets)
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


def _check_slot_args(bins, flow, offsets, valid, word_off, row_words, caps, rounds,
                     name: str, n: int, dev) -> None:
    for t, what in ((bins, "bins"), (flow, "flow"), (offsets, "offsets")):
        require(t, f"{name} {what}", _I32, (n,), dev)
    require(valid, f"{name} valid", torch.bool, (n,), dev)
    nflows = word_off.shape[0]
    for t, what in ((word_off, "word_off"), (row_words, "row_words"),
                    (caps, "caps"), (rounds, "rounds")):
        require(t, f"{name} {what}", _I32, (nflows,), dev)


def ragged_slots(bins, flow, offsets, valid, rnd: int, word_off, row_words, caps,
                 rounds, wtot: int, sentinel: int) -> torch.Tensor:
    """Ragged fused-wire word slot of each item for retry round ``rnd``
    (:func:`ragged_slots_plain`); the CUDA kernel shares its slot
    computation with ``pack_rows``."""
    if not bins.is_cuda:
        return ragged_slots_plain(bins, flow, offsets, valid, rnd, word_off, row_words,
                                  caps, rounds, wtot, sentinel)
    n = bins.shape[0]
    _check_slot_args(bins, flow, offsets, valid, word_off, row_words, caps, rounds,
                     "ragged_slots", n, bins.device)
    out = torch.empty(n, dtype=_I32, device=bins.device)
    _RAGGED_SLOTS(bins, flow, offsets, valid, n, word_off, row_words, caps, rounds,
                  word_off.shape[0], rnd, wtot, sentinel, out)
    return out


def pack_rows_plain(rows, bins, flow, offsets, valid, rnd: int, word_off,
                    row_words, caps, rounds, wtot: int, total: int) -> torch.Tensor:
    """Slots, then a row scatter into a zeroed ``(total,)`` buffer (``ops.py:406-410``)."""
    if total >= 1 << 31:
        raise ValueError(f"pack_rows: {total} words exceed int32 slots")
    slots = ragged_slots_plain(bins, flow, offsets, valid, rnd, word_off, row_words,
                               caps, rounds, wtot, total)
    return scatter_rows(torch.zeros(total, dtype=_I32, device=rows.device), slots,
                        rows, widths=row_words[flow.to(torch.int64)])


def pack_rows(rows, bins, flow, offsets, valid, rnd: int, word_off, row_words,
              caps, rounds, wtot: int, total: int) -> torch.Tensor:
    """Fused ragged wire pack: the ``(total,)`` send buffer for round ``rnd``.

    ``rows`` is the (N, wmax) right-padded row matrix (flow ``f`` uses its
    first ``row_words[f]`` lanes); words nobody writes are 0.

    CUDA: a memset, then one warp per 32 rows: each lane computes one
    row's slot (the ``ragged_slot`` that ``ragged_slots`` shares) and the
    warp copies the rows' words lane by lane, so rows at consecutive
    slots go out as contiguous stores.
    """
    if not rows.is_cuda:
        return pack_rows_plain(rows, bins, flow, offsets, valid, rnd, word_off,
                               row_words, caps, rounds, wtot, total)
    n, wmax = rows.shape
    nflows = word_off.shape[0]
    dev = rows.device
    require(rows, "pack_rows rows", _I32, (n, wmax), dev)
    _check_slot_args(bins, flow, offsets, valid, word_off, row_words, caps, rounds,
                     "pack_rows", n, dev)
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


# --------------------------------------------------------------------------
# row_mix: the wire checksum hash
# --------------------------------------------------------------------------

def row_mix_plain(rows: torch.Tensor) -> torch.Tensor:
    """Per-row u32 hash of an (N, L) word matrix (``ops.py:433-457``).

    Lane ``l`` is weighted by ``0x9E3779B1 * (2l + 1)`` mod 2**32, the
    weighted sum (mod 2**32) is finished with fmix32; an all-zero row
    hashes to 0.  Returns (N,) int32 words.
    """
    h = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for lane in range(rows.shape[1]):
        h = h + mul32(as_u64(rows[:, lane]), (_MIX * (2 * lane + 1)) & M32)
    return fmix32(to_i32(h))


def row_mix(rows: torch.Tensor) -> torch.Tensor:
    """The wire checksum hash of each row (:func:`row_mix_plain`).

    CUDA: one thread per row; the rows may sit at any row stride (lanes
    contiguous), so a segment view is hashed in place.
    """
    if not rows.is_cuda:
        return row_mix_plain(rows)
    m, lanes = rows.shape
    if rows.dtype != _I32 or (m and lanes > 1 and rows.stride(1) != 1) \
            or (m > 1 and rows.stride(0) < lanes):
        raise ValueError(f"row_mix: want an int32 (N, L) tensor with contiguous lanes, "
                         f"got {rows.dtype} of shape {tuple(rows.shape)} and strides "
                         f"{rows.stride()}")
    out = torch.empty(m, dtype=_I32, device=rows.device)
    _ROW_MIX(rows, m, rows.stride(0) if m > 1 else lanes, lanes, out)
    return out


# --------------------------------------------------------------------------
# histogram
# --------------------------------------------------------------------------

def histogram_plain(bins: torch.Tensor, nbins: int, valid: torch.Tensor) -> torch.Tensor:
    """Per-bin counts of the valid items; bins outside ``[0, nbins)`` are
    not counted.  Returns (nbins,) int32."""
    b = bins.to(torch.int64)
    keep = valid & (b >= 0) & (b < nbins)
    return torch.bincount(torch.where(keep, b, nbins),
                          minlength=nbins + 1)[:nbins].to(_I32)


def histogram(bins: torch.Tensor, nbins: int, valid: torch.Tensor) -> torch.Tensor:
    """Per-bin valid counts (:func:`histogram_plain`), exact integers.

    CUDA: 16-byte loads of the bins, 512 items a warp a step; up to 4 bins
    one ballot per bin and item (the warp's counts in registers), above
    lanes of equal bins merged by ``__match_any_sync`` into per-warp shared
    counters; one flush per block to global memory (past 12288 bins,
    global atomics).
    """
    if not bins.is_cuda:
        return histogram_plain(bins, nbins, valid)
    n = bins.shape[0]
    require(bins, "histogram bins", _I32, (n,), bins.device)
    require(valid, "histogram valid", torch.bool, (n,), bins.device)
    if nbins < 1:
        raise ValueError(f"histogram: {nbins} bins")
    out = torch.empty(nbins, dtype=_I32, device=bins.device)
    _HISTOGRAM(bins, valid, n, nbins, out)
    return out
