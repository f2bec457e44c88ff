"""bin_offsets' one-pass tiles and pack_rows' row tiles, emulated on the CPU.

``csrc/binning.cu`` runs only on the card.  ``emulate_bin_offsets``
repeats ``bo_rank_tiles`` step by step: the items cut into tiles of
``TILE`` items, each tile's 8 warps ranking their chunks in order 32
items a step (``rank_chunk``: at one bin, one ballot per bin, every lane
keeping both counts; above, ``__match_any_sync`` groups and the lowest
peer advancing the warp's count), the warps'
counts scanned into each warp's base and the tile's aggregate, and the
decoupled look-back across tiles (``look_back``: with at most 4 bins, the
invalid one included, a warp reads 32 preceding tiles' status words at a
time, else a lane per
bin reads one tile at a time; a tile that has not published is read
again), with the tiles taking their indices in order and advancing in a
seeded random interleaving.  ``emulate_pack_rows`` repeats
``pack_rows_kernel``: each lane's row slot (``ragged_slot``) once, and
the warp's walk over its 32 rows' words, lane l on words l, l + 32, ...,
its row and column advanced by the constant step 32 = a * wmax + b.

Each is held bit for bit against the plain versions (``bin_offsets_plain``,
``pack_rows_plain``) and the JAX package's jnp path, and at one small
size against its Pallas kernels in interpret mode.  Inputs come from
numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import binning
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LANES = 32
WARPS = 8
TILE = binning._TILE_ITEMS
WINDOW_BINS = 4              # at most this many bins: a warp per bin looks back
X, A, P = 0, 1, 2            # status flags: nothing published, aggregate, prefix

# the JAX package's jnp paths, each traced whole under one jit (faster than
# running them op by op)
_jnp_bin_offsets = jax.jit(lambda bins, valid, nbins: jops.bin_offsets(
    bins, nbins, valid, impl="jnp"), static_argnames="nbins")
_jnp_pack_rows = jax.jit(lambda *a, rnd, wtot, total: jops.pack_rows(
    *a[:5], rnd, *a[5:], wtot, total, impl="jnp"), static_argnames=("rnd", "wtot", "total"))


def _lower_peers(mask: np.ndarray) -> np.ndarray:
    """``__popc(ballot & lanemask_lt)`` for each lane of a step."""
    return np.cumsum(mask) - mask


def rank_chunk(b: np.ndarray, nb: int, ballot: bool):
    """One warp's chunk in order, 32 items a step: each item's rank among
    its bin's items in the chunk, and the chunk's per-bin counts."""
    r = np.zeros(b.shape[0], np.int64)
    cnt = np.zeros(nb, np.int64)
    for s in range(0, b.shape[0], LANES):
        step = b[s:s + LANES]
        if ballot:                            # one ballot per bin
            for k in range(nb):
                m = step == k
                r[s:s + LANES][m] = (cnt[k] + _lower_peers(m))[m]
                cnt[k] += m.sum()
        else:                                 # __match_any_sync peers
            prior = cnt[step]                 # every peer reads the count first
            for lane, k in enumerate(step):
                r[s + lane] = prior[lane] + (step[:lane] == k).sum()
            for k in np.unique(step):         # then the lowest peer advances it
                cnt[k] += (step == k).sum()
    return r, cnt


def look_back(status_flag, status_val, t: int, k: int, window: bool):
    """The exclusive prefix of bin k before tile t; yields at every read of
    the status words, so other tiles advance in between."""
    ex = 0
    if window:                                # lanes 0..31 read tiles j, j-1, ...
        j = t - 1
        while True:
            p = j - np.arange(LANES)
            yield
            flag = np.where(p >= 0, status_flag[np.maximum(p, 0), k], P)
            val = np.where(p >= 0, status_val[np.maximum(p, 0), k], 0)
            first = int(np.argmax(flag == P)) if (flag == P).any() else LANES - 1
            if (flag[:first + 1] == X).any():
                continue                      # read the window again
            ex += int(val[:first + 1].sum())
            if (flag == P).any():
                return ex
            j -= LANES
    p = t - 1
    while p >= 0:                             # a lane per bin, one tile a read
        yield
        if status_flag[p, k] == X:
            continue
        ex += int(status_val[p, k])
        if status_flag[p, k] == P:
            return ex
        p -= 1
    return ex


def emulate_bin_offsets(bins, nbins, valid, tile=TILE, ballot=None, resident=4, seed=0):
    """bo_rank_tiles over numpy inputs: (counts (nbins,), offsets (n,)) int32.
    ``ballot``: rank by ballots (the kernel does at one bin) or by matches
    (above); by default as the kernel does."""
    n, nb = bins.shape[0], nbins + 1
    ballot = nbins == 1 if ballot is None else ballot
    bucket = np.where(valid & (bins >= 0) & (bins < nbins), bins, nbins).astype(np.int64)
    tiles = -(-n // tile)
    status_flag = np.zeros((tiles, nb), np.int64)    # zeroed per call
    status_val = np.zeros((tiles, nb), np.int64)
    offsets = np.zeros(n, np.int64)
    counts = np.zeros(nb, np.int64)
    chunk = tile // WARPS

    def tile_proc(t):
        beg = t * tile
        b = bucket[beg:beg + tile]
        ranks, warp_counts = [], []
        for w in range(WARPS):
            r, c = rank_chunk(b[w * chunk:(w + 1) * chunk], nb, ballot)
            ranks.append(r)
            warp_counts.append(c)
        base = np.cumsum([np.zeros(nb, np.int64)] + warp_counts, axis=0)   # each warp's base
        agg = base[-1]
        status_flag[t] = P if t == 0 else A           # published at once
        status_val[t] = agg
        yield
        excl = np.zeros(nb, np.int64)
        if t > 0:
            for k in range(nb):
                excl[k] = yield from look_back(status_flag, status_val, t, k,
                                               nb <= WINDOW_BINS)
                status_flag[t, k], status_val[t, k] = P, excl[k] + agg[k]
        for w in range(WARPS):
            items = slice(beg + w * chunk, min(beg + (w + 1) * chunk, n))
            wb = bucket[items]
            offsets[items] = excl[wb] + base[w][wb] + ranks[w]
        if t == tiles - 1:
            counts[:] = excl + agg

    rng = np.random.default_rng(seed)
    live, started = [], 0
    while started < tiles or live:
        while started < tiles and len(live) < resident:   # indices from the counter
            live.append(tile_proc(started))
            started += 1
        proc = live[rng.integers(len(live))]
        try:
            next(proc)
        except StopIteration:
            live.remove(proc)
    return counts[:nbins].astype(np.int32), offsets.astype(np.int32)


def _bin_case(n, nbins, vfrac, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nbins, n).astype(np.int32)
    bins[: n // 2] = np.sort(bins[: n // 2])          # runs of equal bins, as at one rank
    return bins, rng.random(n) < vfrac


def _check_bin_offsets(bins, nbins, valid, got):
    want = binning.bin_offsets_plain(torch.from_numpy(bins), nbins, torch.from_numpy(valid))
    assert torch.equal(torch.from_numpy(got[0]), want[0]), "counts vs plain"
    assert torch.equal(torch.from_numpy(got[1]), want[1]), "offsets vs plain"
    if bins.shape[0]:
        jc, jo = _jnp_bin_offsets(jnp.asarray(bins), jnp.asarray(valid), nbins=nbins)
        assert np.array_equal(got[0], np.asarray(jc)), "counts vs JAX jnp"
        assert np.array_equal(got[1][valid], np.asarray(jo)[valid]), "offsets vs JAX jnp"


@pytest.mark.parametrize("rank", ["ballot", "match"])
@pytest.mark.parametrize("n,vfrac", [
    (0, 0.5), (1, 0.5), (TILE - 1, 0.5), (TILE, 1.0), (TILE + 1, 0.5), (TILE + 1, 0.0),
    (2 * TILE + 33, 0.5)])
def test_bin_offsets_tiles_one_bin(rank, n, vfrac):
    """Tile edges and valid fractions at one bin, ranked by ballots (as the
    kernel does) and by matches (as it does above one bin)."""
    bins, valid = _bin_case(n, 1, vfrac, n)
    got = emulate_bin_offsets(bins, 1, valid, ballot=rank == "ballot", seed=n)
    _check_bin_offsets(bins, 1, valid, got)


@pytest.mark.parametrize("nbins,vfrac", [(2, 0.5), (3, 0.0), (3, 1.0), (4, 0.5), (31, 0.5),
                                         (32, 0.5), (33, 1.0), (1023, 0.5)])
def test_bin_offsets_tiles_bins(nbins, vfrac):
    """Ranked by matches: the paths' bin counts, the window look-back up to 3
    bins and the lane-per-bin look-back past them, up to one launch's most
    bins."""
    bins, valid = _bin_case(TILE + 1, nbins, vfrac, nbins)
    _check_bin_offsets(bins, nbins, valid, emulate_bin_offsets(bins, nbins, valid, seed=nbins))


@pytest.mark.parametrize("nbins", [2, 9, 40])
@pytest.mark.parametrize("resident", [2, 7, 40])
def test_bin_offsets_many_tiles(nbins, resident):
    """Many small tiles advancing in seeded random interleavings: the
    window look-back (2 bins) and the lane look-back (9, 40 bins) across
    tiles that have only published aggregates."""
    bins, valid = _bin_case(9000, nbins, 0.7, nbins + resident)
    for seed in range(3):
        got = emulate_bin_offsets(bins, nbins, valid, tile=256, resident=resident, seed=seed)
        _check_bin_offsets(bins, nbins, valid, got)


def test_bin_offsets_tiles_pallas():
    """At one small size, against the Pallas kernel in interpret mode."""
    bins, valid = _bin_case(300, 3, 0.6, 5)
    got = emulate_bin_offsets(bins, 3, valid, tile=64, resident=3)
    jc, jo = jops.bin_offsets(jnp.asarray(bins), 3, jnp.asarray(valid), impl="pallas")
    assert np.array_equal(got[0], np.asarray(jc))
    assert np.array_equal(got[1][valid], np.asarray(jo)[valid])


# --------------------------------------------------------------------------
# pack_rows
# --------------------------------------------------------------------------

def emulate_pack_rows(rows, bins, flow, off, valid, rnd, woff, roww, caps, rounds, wtot,
                      total):
    """pack_rows_kernel over numpy inputs: the (total,) buffer, and each store
    instruction's (lane, word) targets."""
    n, wmax = rows.shape
    nflows = woff.shape[0]
    out = np.zeros(total, np.int32)
    stores = []
    step_rows, step_cols = divmod(LANES, wmax)
    lanes = np.arange(LANES)
    for r0 in range(0, n, LANES):
        # each lane's row: its slot and width, once (ragged_slot)
        i = np.minimum(r0 + lanes, n - 1)
        f = flow[i]
        fc = np.clip(f, 0, nflows - 1)
        cap = caps[fc].astype(np.int64)
        off_r = off[i].astype(np.int64) - rnd * cap
        ship = ((r0 + lanes < n) & valid[i] & (f >= 0) & (f < nflows) & (rounds[fc] > rnd)
                & (off_r >= 0) & (off_r < cap))
        width = np.where(ship, np.minimum(roww[fc], wmax), 0)
        slot = np.where(ship, bins[i].astype(np.int64) * wtot + woff[fc] + off_r * roww[fc], 0)
        words = min(LANES, n - r0) * wmax
        src = rows[r0:r0 + LANES].reshape(-1)
        row, col = lanes // wmax, lanes % wmax
        for j in range(wmax):                 # lane l: word l + 32 j of the run
            q = lanes + LANES * j
            assert (row == q // wmax).all() and (col == q % wmax).all()
            act = q < words
            r = np.where(act, row, 0)
            tgt = slot[r] + col
            act &= (col < width[r]) & (tgt >= 0) & (tgt < total)
            out[tgt[act]] = src[q[act]]
            stores.append((lanes[act], tgt[act]))
            row, col = row + step_rows, col + step_cols
            wrap = col >= wmax
            row, col = row + wrap, col - wrap * wmax
    return out, stores


def _wire(rng, n, nflows, nprocs, rnd, drop, full=False, wmax=None):
    """A pack_rows call as a commit makes it (numpy): flows of their own row
    widths (``wmax`` wider than some), ranks per (dest, flow) bucket, the
    round's window of each flow still retrying, the live flows' segments in
    order; at one rank the flows are concatenated in batch order.  ``drop``
    cuts the buffer short; ``full``: every row valid, of width ``wmax``,
    one round holding every rank; ``wmax``: rows that wide, the flows'
    widths from half of it up to it."""
    if wmax is not None:
        roww = rng.integers(max(1, wmax // 2), wmax + 1, nflows)
    else:
        roww = np.full(nflows, 3) if full else rng.integers(1, 7, nflows)
        wmax = int(roww.max()) + (0 if full else int(rng.integers(0, 2)))
    flow = np.sort(rng.integers(0, nflows, n)) if nprocs == 1 else rng.integers(0, nflows, n)
    dest = rng.integers(0, nprocs, n)
    valid = np.ones(n, bool) if full else rng.random(n) < 0.9
    _, offs = binning.bin_offsets_plain(torch.from_numpy(dest * nflows + flow), nprocs * nflows,
                                        torch.from_numpy(valid))
    caps = (np.full(nflows, n) if full else
            rng.integers(n // (4 * nprocs * nflows) + 1, n // (nprocs * nflows) + 2, nflows))
    rounds = np.ones(nflows, np.int64) if full else rng.integers(1, 4, nflows)
    rounds[0] = max(rounds[0], rnd + 1)              # a flow ships in this round
    live = rounds > rnd
    seg = np.where(live, caps * roww, 0)
    woff = np.cumsum(seg) - seg
    wtot = int(seg.sum())
    total = nprocs * wtot - (int(rng.integers(1, wtot)) if drop else 0)
    rows = rng.integers(-(1 << 31), 1 << 31, (n, wmax)).astype(np.int32)
    i32 = [a.astype(np.int32) for a in (dest, flow, offs.numpy(), woff, roww, caps, rounds)]
    return (rows, *i32[:3], valid, rnd, *i32[3:], wtot, total)


def _check_pack(args, got, impl="jnp"):
    t = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
         for a in args]
    assert torch.equal(torch.from_numpy(got), binning.pack_rows_plain(*t)), "vs plain"
    j = [jnp.asarray(a.view(np.uint32) if a.dtype == np.int32 and a.ndim == 2 else a)
         if isinstance(a, np.ndarray) else a for a in args]
    want = (_jnp_pack_rows(*j[:5], *j[6:10], rnd=j[5], wtot=j[10], total=j[11])
            if impl == "jnp" else jops.pack_rows(*j, impl=impl))
    want = np.asarray(want).view(np.int32)
    assert np.array_equal(got, want), f"vs JAX {impl}"


@pytest.mark.parametrize("n,nflows,nprocs,rnd,drop,wmax", [
    (100, 1, 1, 0, False, None), (700, 3, 1, 1, False, None), (1000, 8, 1, 2, True, None),
    (500, 5, 8, 0, True, None), (1000, 8, 8, 1, False, None), (333, 4, 8, 2, True, None),
    (300, 3, 1, 0, False, 8), (300, 4, 8, 1, True, 31), (257, 2, 1, 0, True, 32),
    (300, 5, 8, 2, False, 33), (200, 3, 8, 0, True, 65), (150, 1, 1, 0, False, 65)])
def test_pack_rows_tiles(n, nflows, nprocs, rnd, drop, wmax):
    """Flows of other widths, retry windows, dropped rows, at one rank (P=1)
    and at random destinations (P=8); rows up to 7 words wide (a lane
    step of several rows), and 8, 31, 32, 33 and 65 words (one row or
    less a step, one wrap at most)."""
    args = _wire(np.random.default_rng(n + nflows + rnd), n, nflows, nprocs, rnd, drop,
                 wmax=wmax)
    got, _ = emulate_pack_rows(*args)
    _check_pack(args, got)


def test_pack_rows_store_pattern():
    """At one rank with every row valid and full width, rows of a flow land
    at consecutive slots, so every store instruction of a whole warp writes
    32 consecutive words (128 bytes)."""
    args = _wire(np.random.default_rng(3), 1000, 2, 1, 0, False, full=True)
    got, stores = emulate_pack_rows(*args)
    _check_pack(args, got)
    flow = args[2]
    for idx, (lanes, tgt) in enumerate(stores):
        r0 = idx // args[0].shape[1] * LANES
        rows = flow[r0:r0 + LANES]
        if rows.shape[0] == LANES and (rows == rows[0]).all():
            assert np.array_equal(lanes, np.arange(LANES))
            assert np.array_equal(tgt, tgt[0] + np.arange(LANES))


def test_pack_rows_tiles_pallas():
    """At one small size, against the Pallas kernel in interpret mode."""
    args = _wire(np.random.default_rng(11), 120, 3, 2, 1, False)
    got, _ = emulate_pack_rows(*args)
    _check_pack(args, got, impl="pallas")
