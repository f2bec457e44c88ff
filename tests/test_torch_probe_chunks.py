"""The hash probes' block-staged CUDA algorithms, emulated in numpy on the CPU.

``csrc/hash_probe.cu`` and ``csrc/binning.cu`` run only on the card.
``emulate_bin_csr`` repeats ``bin_csr``, the probes' CSR: a stable
counting sort of the items by digits of their block: the count pass over
every digit, then one pass per digit (each warp ranking its words in
order 32 a step, a tile publishing its aggregates, sorting itself by
digit and looking back a thread per digit over the earlier tiles' status
words, the tiles advancing in seeded random interleavings; the tile
written out by digit runs), then the starts from the sorted bins.
``emulate_histogram`` repeats ``histogram_kernel``: 512 items a warp a
step, ballots up to 4 bins, shared counters (per warp while they fit)
above, global ones past 12288 bins.
``emulate_insert`` repeats ``probe_insert_blocks`` step for step: the
staged block, its FREE and READY slots listed by ballot prefix counts,
and per step of 32 lanes: each lane's first READY match (``list_match``:
the first hit of the READY list, to which new keys are appended), the
lanes grouped by ``__match_any_sync`` on the first two key words
(wider keys then checked word by word), the lowest lane of a group
leading it, free slots taken in lane order by a ballot prefix count
against the running free list, and the per-mode combine.
``emulate_find`` repeats ``probe_find_blocks``: the same CSR, READY list
and match, the hits written to zeroed outputs; ``emulate_find_queries``
the sparse batches' route, one warp per query.  ``bin_offsets``' large-bin
composition (``binning.bin_offsets_lsd``) runs over ``emulate_bin_csr``.

Each is held against the plain versions (``bin_csr_plain``,
``insert_plain``, ``find_plain``, ``bin_offsets_plain``,
``histogram_plain``) and the JAX package (its jnp path; the Pallas
histogram in interpret mode), bit for bit: every output is integer.
Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binning as jbinning
from repro.kernels import ops as jops
from repro_torch.kernels import binning, hash_probe
from repro_torch.kernels.ref import MODE_ADD, MODE_KEEP, MODE_SET
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LANES = 32
MODES = [MODE_SET, MODE_ADD, MODE_KEEP]
M32 = 0xFFFFFFFF


def _popc(x: int) -> int:
    return bin(x).count("1")


def _ffs(x: int) -> int:
    """Lowest set bit's index plus one, 0 for none (CUDA's __ffs)."""
    return (x & -x).bit_length()


def _ballot(pred) -> int:
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _ready_list(sst, skey) -> list:
    """list_ready: the block's READY slots ascending, with their keys."""
    return [(s, skey[s].copy()) for s in range(sst.shape[0]) if sst[s] & 3 == 2]


def _list_match(ready, key, bsz) -> int:
    """list_match: the first READY-list entry holding ``key``, or B."""
    for slot, k in ready:
        if (k == key).all():
            return slot
    return bsz


def emulate_insert(tkeys, tvals, status, qblock, qkeys, qvals, qvalid, mode):
    """probe_insert_blocks on u32 numpy tables; returns new tables and ok."""
    nb, bsz, lk = tkeys.shape
    lv = tvals.shape[2]
    order, start = (t.numpy() for t in hash_probe.bin_queries(
        _t(qblock.astype(np.int32)), _t(qvalid), nb))
    otk, otv, ost = tkeys.copy(), tvals.copy(), status.copy()
    ok = np.zeros(qblock.shape[0], bool)
    for blk in range(nb):
        sst, skey, sval = ost[blk], otk[blk], otv[blk]      # staged, written back in place
        begin, end = int(start[blk]), int(start[blk + 1])
        if begin == end:
            continue
        sfree, nfree = [0] * bsz, 0
        for c in range(0, bsz, LANES):
            f = [c + lane < bsz and sst[c + lane] & 3 == 0 for lane in range(LANES)]
            bal = _ballot(f)
            for lane in range(LANES):
                if f[lane]:
                    sfree[nfree + _popc(bal & ((1 << lane) - 1))] = c + lane
            nfree += _popc(bal)
        ready = _ready_list(sst, skey)
        head = 0
        for base in range(begin, end, LANES):
            act = [base + lane < end for lane in range(LANES)]
            amask = _ballot(act)
            q = [int(order[base + lane]) if act[lane] else 0 for lane in range(LANES)]
            qk = [qkeys[q[lane]] for lane in range(LANES)]
            qv = [qvals[q[lane]] for lane in range(LANES)]
            match = [_list_match(ready, qk[lane], bsz) if act[lane] else bsz
                     for lane in range(LANES)]
            # __match_any_sync on (k0, k1); an idle lane holds (0, 0)
            k64 = [(int(qk[lane][0]) | (int(qk[lane][1]) << 32 if lk > 1 else 0))
                   if act[lane] else 0 for lane in range(LANES)]
            peers = [_ballot(k == k64[lane] for k in k64) & amask for lane in range(LANES)]
            if lk > 2:
                peers = [sum(1 << o for o in range(LANES)
                             if peers[lane] >> o & 1 and all(qk[o][2:] == qk[lane][2:]))
                         if act[lane] else 0 for lane in range(LANES)]
            leader = [_ffs(peers[lane]) - 1 if act[lane] else lane for lane in range(LANES)]
            lead = [act[lane] and leader[lane] == lane for lane in range(LANES)]
            fresh = [lead[lane] and match[lane] == bsz for lane in range(LANES)]
            fb = _ballot(fresh)
            slot = []
            for lane in range(LANES):
                r = _popc(fb & ((1 << lane) - 1))
                slot.append(match[lane] if match[lane] < bsz else
                            sfree[head + r] if fresh[lane] and head + r < nfree else bsz)
            lead_ok = [lead[lane] and slot[lane] < bsz for lane in range(LANES)]
            okb = _ballot(lead_ok)
            for lane in range(LANES):
                if act[lane]:
                    ok[q[lane]] = bool(okb >> leader[lane] & 1)
            head += min(_popc(fb), nfree - head)
            for lane in range(LANES):
                if not lead_ok[lane]:
                    continue
                s = slot[lane]
                sst[s] = (sst[s] & ~np.uint32(3)) | np.uint32(2)
                skey[s] = qk[lane]
                if match[lane] == bsz:      # a new key joins the READY list, lane order
                    ready.append((s, qk[lane].copy()))
                members = [o for o in range(LANES) if peers[lane] >> o & 1]
                if mode == MODE_SET:
                    sval[s] = qv[members[-1]]
                elif mode == MODE_ADD:
                    acc = sval[s].astype(np.uint64) if match[lane] < bsz else np.zeros(
                        lv, np.uint64)
                    for o in members:
                        acc = (acc + qv[o]) & M32
                    sval[s] = acc.astype(np.uint32)
                elif match[lane] == bsz:
                    sval[s] = qv[lane]
    return otk, otv, ost, ok


def emulate_find(tkeys, tvals, status, qblock, qkeys, qvalid):
    """probe_find_blocks on numpy tables: the CSR, outputs zeroed, each
    touched block staged and its queries matched 32 at a time, the hits
    written to their rows."""
    nb, bsz, _ = tkeys.shape
    m, lv = qblock.shape[0], tvals.shape[2]
    order, start = (t.numpy() for t in hash_probe.bin_queries(_t(qblock), _t(qvalid), nb))
    found = np.zeros(m, bool)
    vals = np.zeros((m, lv), np.uint32)
    for blk in range(nb):
        if start[blk] == start[blk + 1]:
            continue                        # untouched: not read
        ready = _ready_list(status[blk], tkeys[blk])
        for base in range(start[blk], start[blk + 1], LANES):
            for lane in range(LANES):
                if base + lane >= start[blk + 1]:
                    continue
                q = int(order[base + lane])
                match = _list_match(ready, qkeys[q], bsz)
                if match < bsz:
                    found[q] = True
                    vals[q] = tvals[blk, match]
    return found, vals


def emulate_find_queries(tkeys, tvals, status, qblock, qkeys, qvalid):
    """probe_find_queries (a sparse batch): per query, its block's slots
    32 at a time from the table, the first ballot of READY matches."""
    nb, bsz, _ = tkeys.shape
    m, lv = qblock.shape[0], tvals.shape[2]
    found = np.zeros(m, bool)
    vals = np.zeros((m, lv), np.uint32)
    for q in range(m):
        b = int(qblock[q]) if qvalid[q] else -1
        if not 0 <= b < nb:
            continue
        for c in range(0, bsz, LANES):
            hit = _ballot(c + lane < bsz and status[b, c + lane] & 3 == 2
                          and (tkeys[b, c + lane] == qkeys[q]).all() for lane in range(LANES))
            if hit:
                found[q] = True
                vals[q] = tvals[b, c + _ffs(hit) - 1]
                break
    return found, vals


def _table(rng, nb, bsz, lk, lv, key_hi):
    """States 0-3 (FREE most often), keys from a small range (so READY
    slots share keys), read flags in the high status bits."""
    tk = rng.integers(0, key_hi, (nb, bsz, lk)).astype(np.uint32)
    tv = rng.integers(0, 1 << 32, (nb, bsz, lv), dtype=np.uint64).astype(np.uint32)
    state = rng.choice(4, (nb, bsz), p=[0.55, 0.05, 0.35, 0.05]).astype(np.uint32)
    state[:, :2] = 2
    tk[:, 1] = tk[:, 0]                     # every block: one key in two READY slots
    st = state | (rng.integers(0, 1 << 20, (nb, bsz)).astype(np.uint32) << 7)
    return tk, tv, st


def _items(rng, tk, m, lv, key_hi, frac_valid=0.9):
    """Items over the table's blocks; a quarter carry a stored key of their block."""
    nb, bsz, lk = tk.shape
    qb = rng.integers(0, nb, m).astype(np.int32)
    qk = rng.integers(0, key_hi, (m, lk)).astype(np.uint32)
    stored = rng.random(m) < 0.25
    qk[stored] = tk[qb[stored], rng.integers(0, bsz, int(stored.sum()))]
    qv = rng.integers(0, 1 << 32, (m, lv), dtype=np.uint64).astype(np.uint32)
    return qb, qk, qv, rng.random(m) < frac_valid


def _check_insert(tk, tv, st, qb, qk, qv, valid, mode):
    got = emulate_insert(tk, tv, st, qb, qk, qv, valid, mode)
    plain = hash_probe.insert_plain(*map(_t, (tk, tv, st, qb, qk, qv, valid)), mode)
    seg = np.concatenate([qb.astype(np.uint32)[:, None], qk, qv], axis=1)
    jax_out = jops.bulk_insert_arrivals(*map(jnp.asarray, (tk, tv, st, seg, valid)), mode,
                                        impl="jnp")
    arrivals = hash_probe.insert_arrivals_plain(*map(_t, (tk, tv, st, seg, valid)), mode)
    for name, g, p, j, a in zip(("tkeys", "tvals", "status", "success"), got, plain,
                                jax_out, arrivals):
        g = _t(g)
        assert torch.equal(g, p), f"emulation vs insert_plain: {name}"
        assert torch.equal(g, a), f"emulation vs insert_arrivals_plain: {name}"
        assert torch.equal(g, _t(np.asarray(j))), f"emulation vs JAX jnp: {name}"
    return got


# B, Lk, Lv, blocks, items, key range: ~70 items a block (three steps),
# keys from a range small enough for duplicates within and across steps
# (one item count and block count throughout: JAX compiles each shape once)
INSERT_CASES = [(33, 1, 1, 3, 210, 24), (40, 2, 2, 3, 210, 20), (64, 3, 1, 3, 210, 12),
                (64, 1, 2, 3, 210, 90), (33, 3, 2, 3, 210, 30)]


@pytest.mark.parametrize("mode", MODES, ids=["set", "add", "keep"])
@pytest.mark.parametrize("bsz,lk,lv,nb,m,key_hi", INSERT_CASES)
def test_insert_steps_match_plain_and_jax(mode, bsz, lk, lv, nb, m, key_hi):
    rng = np.random.default_rng(bsz * 100 + lk * 10 + lv + mode)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, key_hi)
    qb, qk, qv, valid = _items(rng, tk, m, lv, key_hi)
    if lk > 2:      # keys equal in the first two words, not in the third
        qk[1::7, :2] = qk[0, :2]
    qk[2::9] = tk[qb[2::9], 1]              # the key its block holds in two READY slots
    _, _, _, ok = _check_insert(tk, tv, st, qb, qk, qv, valid, mode)
    assert ok[valid].any() and not ok[~valid].any()
    assert (qk[valid] == tk[qb[valid], 1]).all(axis=1).any(), "a key held in two READY slots"


@pytest.mark.parametrize("mode", MODES, ids=["set", "add", "keep"])
def test_insert_crafted_steps(mode):
    """One block of 40 slots with three FREE: the first step's new keys
    fill it at lane 3; a key the block holds in two READY slots sits at
    lanes 31 and 32, straddling the step boundary, and both update the
    first slot; a duplicate of a key that found no room fails too; states
    1 and 3 are neither free nor matched."""
    bsz, lk = 40, 2
    tk = np.zeros((1, bsz, lk), np.uint32)
    tk[0, :, 0] = np.arange(bsz) + 100
    tv = (np.arange(bsz, dtype=np.uint32) * 7).reshape(1, bsz, 1)
    st = np.full((1, bsz), 2, np.uint32) | (np.arange(bsz, dtype=np.uint32) << 7)
    st[0, [5, 17, 30]] &= ~np.uint32(3)     # three FREE slots
    st[0, [8, 9]] = (st[0, [8, 9]] & ~np.uint32(3)) | [3, 1]   # neither free nor matchable
    tk[0, 12] = tk[0, 11]                   # one key in two READY slots
    keys = [[1000 + i, 0] for i in range(31)] + [[111, 0], [111, 0], [108, 0], [1001, 0],
                                                 [111, 0], [1000, 0], [1003, 0]]
    keys += [[101, 0]] * 30
    qk = np.array(keys, np.uint32)
    m = qk.shape[0]
    qb = np.zeros(m, np.int32)
    qv = (np.arange(m, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)[:, None]
    valid = np.ones(m, bool)
    valid[40] = False
    _, otv, ost, ok = _check_insert(tk, tv, st, qb, qk, qv, valid, mode)
    assert ok[:3].all() and not ok[3:31].any()          # the block fills at lane 3
    assert ok[31] and ok[32] and ok[34] and ok[35] and ok[36]
    assert not ok[33] and not ok[37] and not ok[40]     # reserved slot; no room; invalid
    assert (ost[0, [8, 9]] & 3).tolist() == [3, 1]
    want = {MODE_SET: int(qv[35, 0]), MODE_KEEP: int(tv[0, 11, 0]),
            MODE_ADD: (int(tv[0, 11, 0]) + int(qv[31:33, 0].sum()) + int(qv[35, 0])) & M32}
    assert int(otv[0, 11, 0]) == want[mode] and otv[0, 12, 0] == tv[0, 12, 0]


# nb, B, Lk, Lv, m, key range
FIND_CASES = [(3, 33, 1, 1, 210, 30), (3, 40, 2, 2, 210, 25), (3, 64, 3, 1, 210, 12),
              (3, 64, 1, 3, 210, 60)]


@pytest.mark.parametrize("nb,bsz,lk,lv,m,key_hi", FIND_CASES)
def test_find_blocks_match_plain_and_jax(nb, bsz, lk, lv, m, key_hi):
    rng = np.random.default_rng(nb * 1000 + bsz + lk)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, key_hi)
    qb, qk, _, valid = _items(rng, tk, m, lv, key_hi)
    found, vals = emulate_find(tk, tv, st, qb, qk, valid)
    pf, pv = hash_probe.find_plain(*map(_t, (tk, tv, st, qb, qk, valid)))
    assert torch.equal(_t(found), pf) and torch.equal(_t(vals), pv)
    sf, sv = emulate_find_queries(tk, tv, st, qb, qk, valid)
    assert np.array_equal(sf, found) and np.array_equal(sv, vals)
    jf, jv = jops.bulk_find(*map(jnp.asarray, (tk, tv, st, qb, qk, valid)), impl="jnp")
    assert torch.equal(_t(found), _t(np.asarray(jf))) and torch.equal(_t(vals),
                                                                        _t(np.asarray(jv)))
    seg = np.concatenate([qb.astype(np.uint32)[:, None], qk], axis=1)
    af, av = hash_probe.find_arrivals_plain(*map(_t, (tk, tv, st, seg, valid)))
    assert torch.equal(_t(found), af) and torch.equal(_t(vals), av)
    assert 0 < found.sum() < valid.sum()


def test_find_blocks_out_of_range():
    """A valid query whose block lies outside [0, nb) finds nothing; the
    rest agree with the plain version."""
    rng = np.random.default_rng(5)
    nb, bsz, lk, lv, m = 3, 40, 2, 2, 120
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 20)
    qb, qk, _, valid = _items(rng, tk, m, lv, 20)
    far = rng.random(m) < 0.2
    qb[far] = np.where(rng.random(far.sum()) < 0.5, -1 - qb[far], nb + qb[far])
    found, vals = emulate_find(tk, tv, st, qb, qk, valid)
    assert not found[far].any() and not vals[far].any()
    sf, sv = emulate_find_queries(tk, tv, st, qb, qk, valid)
    assert np.array_equal(sf, found) and np.array_equal(sv, vals)
    pf, pv = hash_probe.find_plain(*map(_t, (tk, tv, st, np.where(far, 0, qb), qk,
                                            valid & ~far)))
    assert torch.equal(_t(found), pf) and torch.equal(_t(vals), pv)


WARPS = 8
X, A, P = 0, 1, 2            # status flags: nothing published, aggregate, prefix


STEPS = 32                   # words a csr_pass lane holds: 8192-word tiles (``kCsrSteps``)


def count_item(b: np.ndarray, cnt: np.ndarray) -> None:
    """count_item for a step of items: one shared atomicAdd per item whose
    bucket is not negative."""
    np.add.at(cnt, b[b >= 0], 1)


def _digits(w: np.ndarray, shift: int, nd: int) -> np.ndarray:
    return np.where(w >= 0, (w >> (32 + shift)) & (nd - 1), nd)


def emulate_count(bins, valid, nbins, plan, ctas: int = 3) -> list:
    """csr_count: each CTA counts every pass's digits of its items (grid
    stride) in shared counters and flushes them with atomics; the last CTA
    to finish scans each pass's counts into digit starts."""
    n = bins.shape[0]
    live = valid & (bins >= 0) & (bins < nbins)
    counts = [np.zeros(nd + 1, np.int64) for _, nd in plan]
    for cta in range(ctas):
        items = (np.arange(n) // 256) % ctas == cta
        for (shift, nd), cnt in zip(plan, counts):
            tally = np.zeros(nd + 1, np.int64)
            count_item(np.where(live[items], (bins[items] >> shift) & (nd - 1), nd), tally)
            cnt += tally                               # the flush
    return [np.cumsum(c) - c for c in counts]


def rank_tile(d: np.ndarray, nb: int, steps: int):
    """Each warp's chunk of a tile in order, 32 words a step: each word's
    rank among its digit's words in the chunk (its peers: the lanes whose
    digit agrees with it in every bit, one ballot per bit; the lowest peer
    advances the warp's count), and each warp's counts."""
    chunk = LANES * steps
    rank = np.zeros(d.shape[0], np.int64)
    wcnt = np.zeros((WARPS, nb), np.int64)
    for w in range(WARPS):
        run = wcnt[w]
        for s in range(w * chunk, min((w + 1) * chunk, d.shape[0]), LANES):
            step = d[s:s + LANES]
            peers = np.ones((step.shape[0], step.shape[0]), bool)
            for bit in range(int(nb).bit_length()):  # one ballot per bit
                set_ = (step >> bit) & 1
                peers &= set_[:, None] == set_[None, :]
            prior = run[step]                          # every peer reads the count first
            rank[s:s + LANES] = prior + np.tril(peers, -1).sum(1)
            run[step] = prior + peers.sum(1)           # then the lowest peer advances it
    return rank, wcnt


def look_back(flag, val, t: int, nb: int):
    """Each digit's count in the tiles before tile t, a thread per digit (all
    at once) reading one earlier tile a time back to an inclusive prefix (a
    word not yet published is read again); yields at every read, so other
    tiles advance in between."""
    ex = np.zeros(nb, np.int64)
    p = np.full(nb, t - 1)
    done = np.zeros(nb, bool)
    k = np.arange(nb)
    while not done.all():
        yield
        f = np.where(done, X, flag[p, k])
        seen = ~done & (f != X)
        ex[seen] += val[p[seen], k[seen]]
        done |= seen & (f == P)
        p[seen & ~done] -= 1
    return ex


def emulate_pass(words, n, shift, nd, dstart, steps, last, nbins, resident, seed):
    """One csr_pass launch: tiles taking their indices in order and advancing
    in a seeded random interleaving.  Returns the words (or, the last pass,
    the order and the sorted bins)."""
    nb, tile = nd + 1, WARPS * LANES * steps
    tiles = -(-n // tile)
    flag = np.zeros((tiles, nb), np.int64)             # zeroed by the call's memset
    val = np.zeros((tiles, nb), np.int64)
    out = np.zeros(n, np.int64)

    def tile_proc(t):
        beg = t * tile
        w = words[beg:beg + tile]
        d = _digits(w, shift, nd)
        rank, wcnt = rank_tile(d, nb, steps)
        wbase = np.cumsum(wcnt, 0) - wcnt                # each warp's base per digit
        agg = wcnt.sum(0)
        flag[t], val[t] = (P if t == 0 else A), agg   # counts, the digit starts apart
        yield
        local = np.cumsum(agg) - agg                   # each digit's start in the tile
        warp = np.arange(w.shape[0]) // (LANES * steps)
        buf = np.empty_like(w)
        buf[local[d] + wbase[warp, d] + rank] = w      # the tile sorted by digit
        ex = (yield from look_back(flag, val, t, nb)) if t > 0 else np.zeros(nb, np.int64)
        if t > 0:
            flag[t], val[t] = P, ex + agg
        assert (val < 1 << 30).all(), "a count fits the status word's 30 bits"
        base = dstart + ex - local                     # where each digit's run goes, less its start
        bd = _digits(buf, shift, nd)
        out[base[bd] + np.arange(buf.shape[0])] = buf  # out by digit runs

    rng = np.random.default_rng(seed)
    live, started = [], 0
    while started < tiles or live:
        while started < tiles and len(live) < resident:  # indices from the counter
            live.append(tile_proc(started))
            started += 1
        proc = live[rng.integers(len(live))]
        try:
            next(proc)
        except StopIteration:
            live.remove(proc)
    if not last:
        return out
    return out & 0xFFFFFFFF, np.where(out >= 0, out >> 32, nbins)


def emulate_starts(sbin: np.ndarray, nbins: int) -> np.ndarray:
    """csr_starts: each bin's start, a binary search of the sorted bins for
    the first place whose bin is the bin or more."""
    b = np.arange(nbins + 1)
    lo, hi = np.zeros_like(b), np.full_like(b, sbin.shape[0])
    while (lo < hi).any():                             # every bin's search, a step at a time
        open_ = lo < hi
        mid = (lo + hi) // 2
        below = open_ & (sbin[np.minimum(mid, max(sbin.shape[0] - 1, 0))] < b) \
            if sbin.shape[0] else np.zeros_like(open_)
        lo = np.where(below, mid + 1, lo)
        hi = np.where(open_ & ~below, mid, hi)
    return lo


def emulate_bin_csr(bins: torch.Tensor, nbins: int, valid: torch.Tensor, steps=None,
                    resident: int = 4, seed: int = 0):
    """bin_csr on the CPU: the count pass, one emulated csr_pass per digit of
    ``digit_widths`` (the first making the words bin << 32 | index, negative
    when not live), then the starts.  ``steps``: words a lane holds (the
    kernel's by default; fewer make small tiles)."""
    b, v = bins.numpy().astype(np.int64), valid.numpy()
    n = b.shape[0]
    widths = binning.digit_widths(nbins)
    plan = [(sum(widths[:p]), 1 << wd) for p, wd in enumerate(widths)]
    steps = STEPS if steps is None else steps
    live = v & (b >= 0) & (b < nbins)
    w = np.where(live, b << 32, -(1 << 32)) | np.arange(n)
    order, sbin = np.zeros(0, np.int64), np.zeros(0, np.int64)
    if n:
        dstarts = emulate_count(b, v, nbins, plan)
        for p, ((shift, nd), dstart) in enumerate(zip(plan, dstarts)):
            w = emulate_pass(w, n, shift, nd, dstart, steps, p == len(plan) - 1, nbins,
                             resident, seed + p)
        order, sbin = w
    start = emulate_starts(sbin, nbins)
    return (torch.from_numpy(order.astype(np.int32)),
            torch.from_numpy(start.astype(np.int32)))


def _check_csr(bins, nbins, valid, **kw):
    got = emulate_bin_csr(_t(bins), nbins, _t(valid), **kw)
    want = binning.bin_csr_plain(_t(bins), nbins, _t(valid))
    assert torch.equal(got[0], want[0]), "order vs bin_csr_plain"
    assert torch.equal(got[1], want[1]), "start vs bin_csr_plain"


@pytest.mark.parametrize("n,nbins", [(5000, 1024), (20000, 4096), (3000, 1 << 20), (0, 2048)])
def test_bin_csr_digit_passes(n, nbins):
    """The emulated bin_csr equals the plain CSR; bin_offsets' large-bin
    composition over it equals the plain version (counts, every offset)
    and JAX's jnp path (counts, the valid items' offsets); invalid items
    and bins outside range included."""
    rng = np.random.default_rng(n + nbins)
    hot = rng.integers(0, nbins, 40)        # a few crowded bins among many empty ones
    bins = np.where(rng.random(n) < 0.5, hot[rng.integers(0, 40, n)],
                    rng.integers(0, nbins, n)).astype(np.int32)
    valid = rng.random(n) < 0.85
    _check_csr(bins, nbins, valid)
    wild = bins.copy()
    wild[::17] = np.where(np.arange(len(wild[::17])) % 2, -3, nbins + 5)   # not live
    _check_csr(wild, nbins, valid)

    offs = binning.bin_offsets_lsd(_t(bins), nbins, _t(valid), emulate_bin_csr)
    plain = binning.bin_offsets_plain(_t(bins), nbins, _t(valid))
    assert torch.equal(offs[0], plain[0]) and torch.equal(offs[1], plain[1])
    jc, jo = jops.bin_offsets(jnp.asarray(bins), nbins, jnp.asarray(valid), impl="jnp")
    assert torch.equal(offs[0], _t(np.asarray(jc)))
    assert torch.equal(offs[1][_t(valid)], _t(np.asarray(jo))[_t(valid)])


TILE = WARPS * LANES * STEPS      # csr_pass's tile


@pytest.mark.parametrize("n,nbins", [(TILE - 1, 3000), (TILE, 3000), (TILE + 1, 3000),
                                     (TILE + 1, 1), (TILE - 1, 1 << 20)])
def test_bin_csr_tile_edges(n, nbins):
    """At the tile's edges: one full tile, one short of it, one word past it
    (a second tile of one word); one bin (one pass of two digits and the
    not-live one) and two passes."""
    rng = np.random.default_rng(n * 7 + nbins)
    bins = rng.integers(-1, nbins + 1, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    _check_csr(bins, nbins, valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_csr_hot_bin(seed):
    """Several tiles where nine items in ten fall in one bin: each digit's
    run spans tiles, most digits absent from a tile (aggregate 0), and the
    look-back crosses tiles that have published only aggregates."""
    rng = np.random.default_rng(seed)
    n, nbins = 3 * TILE + 333, 5000
    bins = np.where(rng.random(n) < 0.9, 4321, rng.integers(0, nbins, n)).astype(np.int32)
    valid = rng.random(n) < 0.95
    _check_csr(bins, nbins, valid, resident=2 + 3 * seed, seed=seed)


@pytest.mark.parametrize("resident", [2, 7, 40])
def test_bin_csr_interleavings(resident):
    """Tiles of 256 words (one word a lane) advancing in seeded random
    interleavings, 2 to 40 at a time: every order of completion gives the
    stable CSR."""
    rng = np.random.default_rng(resident)
    n, nbins = 7000, 2000
    bins = rng.integers(0, nbins, n).astype(np.int32)
    bins[: n // 3] = np.sort(bins[: n // 3])          # runs of equal bins
    valid = rng.random(n) < 0.8
    for seed in range(2):
        _check_csr(bins, nbins, valid, steps=1, resident=resident, seed=seed)


def test_digit_widths():
    assert binning.digit_widths(1 << 20) == [10, 10]
    assert binning.digit_widths(1 << 19) == [10, 9]
    assert binning.digit_widths(1025) == [6, 5]
    assert binning.digit_widths(1) == [1]


def test_bin_queries_is_a_stable_csr():
    """The CSR the probes walk: each block's valid items in batch order."""
    rng = np.random.default_rng(9)
    nb, m = 1500, 20000                      # 11 bits of block: two digit passes
    qb = rng.integers(0, nb, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    order, start = hash_probe.bin_queries(_t(qb), _t(valid), nb)
    key = np.where(valid, qb, nb)
    want = np.argsort(key, kind="stable")
    assert np.array_equal(order.numpy(), want)
    assert np.array_equal(start.numpy(), np.searchsorted(key[want], np.arange(nb + 1)))
    assert all(torch.equal(a, b) for a, b in zip(
        emulate_bin_csr(_t(qb), nb, _t(valid)), (order, start)))


# --------------------------------------------------------------------------
# histogram
# --------------------------------------------------------------------------

FEW_BINS = 4                  # up to this many bins: ballots (``kFewBins``)
MAX_SHARED_BINS = 12288       # above: global atomics (``kMaxSharedBins``)
GROUP = 16                    # items a lane loads a step (``kGroup``)


def emulate_histogram(bins: np.ndarray, nbins: int, valid: np.ndarray) -> np.ndarray:
    """histogram_kernel: each warp takes 512 items a step, lane l holding
    items 4 (32 q + l) + e (16-byte loads), then counts its 16 items: one
    ballot per bin and item up to 4 bins (the warp's counts in registers),
    else count_item into its warp's copy of the counters (one copy per
    warp while 12288 counters allow; past 12288 bins the global counts);
    one flush per CTA."""
    n = bins.shape[0]
    grid = min(-(-n // (256 * GROUP)), 132 * 8)
    copies = 0 if nbins > MAX_SHARED_BINS else min(WARPS, MAX_SHARED_BINS // nbins)
    counts = np.zeros(nbins, np.int64)
    lane = np.arange(LANES)
    item = (4 * (LANES * np.arange(4)[:, None] + lane[None, :]))[:, None, :] \
        + np.arange(4)[None, :, None]                  # [q, e, lane]
    item = item.reshape(GROUP, LANES)                  # [4 q + e, lane]
    for cta in range(grid):
        shared = np.zeros((max(copies, 1), nbins), np.int64)
        for warp in range(WARPS):
            few = np.zeros(FEW_BINS, np.int64)
            cnt = shared[warp % copies] if copies else counts
            for i0 in range((cta * WARPS + warp) * LANES * GROUP, n,
                            grid * WARPS * LANES * GROUP):
                i = i0 + item
                b = np.where(i < n, bins[np.minimum(i, n - 1)], -1)
                ok = (i < n) & valid[np.minimum(i, n - 1)] & (b >= 0) & (b < nbins)
                b = np.where(ok, b, -1)
                for j in range(GROUP):
                    if nbins <= FEW_BINS:
                        few[:nbins] += [(b[j] == k).sum() for k in range(nbins)]
                    else:
                        count_item(b[j], cnt)
            if nbins <= FEW_BINS:
                shared[0] += few[:nbins]
        if nbins <= FEW_BINS or copies:
            counts += shared.sum(0)
    return counts.astype(np.int32)


@pytest.mark.parametrize("nbins", [1, 2, 3, 1024, 12289])
def test_histogram_lanes(nbins):
    """The emulated histogram equals the plain version and the Pallas kernel
    (interpret mode): ballots at 1-3 bins, per-warp counters at 1024, global
    counters past 12288; bins outside range and a ragged last step."""
    rng = np.random.default_rng(nbins)
    n = 3 * 512 + 77
    bins = rng.integers(-2, nbins + 2, n).astype(np.int32)
    bins[:300] = nbins // 2                            # one crowded bin
    valid = rng.random(n) < 0.8
    got = emulate_histogram(bins, nbins, valid)
    assert torch.equal(_t(got), binning.histogram_plain(_t(bins), nbins, _t(valid)))
    want = jbinning.histogram(jnp.asarray(bins), nbins, jnp.asarray(valid), tile=512)
    assert np.array_equal(got, np.asarray(want))
    assert got.sum() == (valid & (bins >= 0) & (bins < nbins)).sum()
