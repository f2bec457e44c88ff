"""The port's kernel modules (plain versions, on the CPU) against the JAX
package's ``impl="jnp"`` paths and its Pallas kernels in interpret mode:
binning and wire packing, the hash probe's arrival and column front
ends, and the Bloom filter's ops (``seg_exclusive_or_scan``,
``bloom_insert``/``bloom_find``, ``hash_words``, ``membership``), plus
the sequential oracles.

Same inputs from a numpy seed through both packages; every output is
integer, so the tolerance is 0: bit for bit.  Pallas batches stay within the Pallas
probe's per-block query capacity (``default_q_cap``: the whole batch
when there are at most 8 blocks); the port has no such capacity.
The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_gpu_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels import bloom_kernel as jbk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import hashing as th
from repro_torch.kernels import bloom_kernel as tbk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IMPLS = ["jnp", "pallas"]


def _u32(rng, shape, lo=0, hi=1 << 32):
    return rng.integers(lo, hi, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy (u32/i32/bool) -> port tensor (u32 words as int32 views)."""
    a = np.array(a)                        # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _same(jax_out, port_out, what, mask=None):
    j = np.asarray(jax_out)
    p = _np(port_out)
    if j.dtype == np.int32:
        p = p.view(np.int32)
    if mask is not None:
        j, p = j[mask], p[mask]
    assert j.shape == p.shape and np.array_equal(j, p), what


# --------------------------------------------------------------------------
# binning: bin_offsets / multi_bin_offsets
# --------------------------------------------------------------------------

BIN_CASES = [
    # n, nbins, fraction valid, bins drawn from [0, used) (the rest stay empty)
    (1, 1, 1.0, 1),
    (100, 4, 0.8, 4),
    (777, 16, 0.5, 5),
    (3000, 9, 1.0, 9),
    (2048, 3, 0.0, 3),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,nbins,frac,used", BIN_CASES)
def test_bin_offsets_matches_jax(impl, n, nbins, frac, used):
    rng = np.random.default_rng(n + nbins)
    bins = rng.integers(0, used, n).astype(np.int32)
    valid = rng.random(n) < frac
    jc, jo = jops.bin_offsets(jnp.asarray(bins), nbins, jnp.asarray(valid), impl=impl)
    tc, to = tops.bin_offsets(_t(bins), nbins, _t(valid), impl="torch")
    _same(jc, tc, "counts")
    _same(jo, to, "offsets of valid items", mask=valid)
    rc, ro = tref.bin_offsets_ref(_t(bins), nbins, _t(valid))
    assert torch.equal(rc, tc) and torch.equal(ro[_t(valid)], to[_t(valid)])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("nprocs,nflows", [(1, 2), (4, 3)])
def test_multi_bin_offsets_matches_jax(impl, nprocs, nflows):
    rng = np.random.default_rng(nprocs * 10 + nflows)
    n = 500
    dest = rng.integers(0, nprocs, n).astype(np.int32)
    flow = rng.integers(0, nflows, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    jc, jo = jops.multi_bin_offsets(jnp.asarray(dest), jnp.asarray(flow), nprocs, nflows,
                                    jnp.asarray(valid), impl=impl)
    tc, to = tops.multi_bin_offsets(_t(dest), _t(flow), nprocs, nflows, _t(valid),
                                    impl="torch")
    assert tuple(tc.shape) == (nprocs, nflows)
    _same(jc, tc, "counts")
    _same(jo, to, "offsets", mask=valid)


# --------------------------------------------------------------------------
# binning: pack_rows / place_rows
# --------------------------------------------------------------------------

PACK_CASES = [
    # nprocs, caps, row words, rounds, rnd
    (1, [8], [3], [1], 0),
    (2, [4, 6], [2, 4], [2, 1], 0),
    (2, [4, 6], [2, 4], [2, 1], 1),
    (3, [3, 2, 5], [1, 3, 2], [3, 2, 1], 2),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("nprocs,caps,roww,rounds,rnd", PACK_CASES)
def test_pack_rows_matches_jax(impl, nprocs, caps, roww, rounds, rnd):
    rng = np.random.default_rng(sum(caps) + rnd)
    nflows, n = len(caps), 120
    dest = rng.integers(0, nprocs, n).astype(np.int32)
    flow = rng.integers(0, nflows, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    _, offs = jops.multi_bin_offsets(jnp.asarray(dest), jnp.asarray(flow), nprocs,
                                     nflows, jnp.asarray(valid), impl="jnp")
    offs = np.asarray(offs)
    wmax = max(roww)
    rows = _u32(rng, (n, wmax))
    live = [f for f in range(nflows) if rounds[f] > rnd]
    woff, w = [0] * nflows, 0
    for f in live:
        woff[f] = w
        w += caps[f] * roww[f]
    tabs = [np.asarray(t, np.int32) for t in (woff, roww, caps, rounds)]
    total = nprocs * w
    want = jops.pack_rows(jnp.asarray(rows), jnp.asarray(dest), jnp.asarray(flow),
                          jnp.asarray(offs), jnp.asarray(valid), rnd,
                          *map(jnp.asarray, tabs), w, total, impl=impl)
    got = tops.pack_rows(_t(rows), _t(dest), _t(flow), _t(offs.astype(np.int32)),
                         _t(valid), rnd, *map(_t, tabs), w, total, impl="torch")
    _same(want, got, "send buffer")
    assert int((got != 0).sum()) <= int(valid.sum()) * wmax   # unused words stay 0
    jslots = jops.ragged_slots(jnp.asarray(dest), jnp.asarray(flow), jnp.asarray(offs),
                               jnp.asarray(valid), rnd, *map(jnp.asarray, tabs), w, total,
                               impl=impl)
    tslots = tops.ragged_slots(_t(dest), _t(flow), _t(offs.astype(np.int32)), _t(valid),
                               rnd, *map(_t, tabs), w, total)
    _same(jslots, tslots, "word slots")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("total,m,w", [(64, 10, 1), (100, 30, 2), (257, 40, 3)])
def test_place_rows_matches_jax(impl, total, m, w):
    rng = np.random.default_rng(total + m)
    dst = _u32(rng, (total,))
    # disjoint rows; some start past the end and drop, one may straddle it
    slots = (rng.permutation(-(-(total + 20) // w))[:m] * w).astype(np.int32)
    rows = _u32(rng, (m, w))
    want = jops.place_rows(jnp.asarray(dst), jnp.asarray(slots), jnp.asarray(rows),
                           impl=impl)
    got = tops.place_rows(_t(dst), _t(slots), _t(rows), impl="torch")
    _same(want, got, "placed buffer")


def test_ops_never_fall_back_from_cuda():
    """impl='cuda' on CPU tensors raises instead of running the plain version."""
    bins = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.bin_offsets(bins, 2, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.bin_offsets(bins, 2, impl="jnp")
    tk, tv = torch.zeros((2, 4, 1), dtype=torch.int32), torch.zeros((2, 4, 1), dtype=torch.int32)
    st, q = torch.zeros((2, 4), dtype=torch.int32), torch.zeros((4, 1), dtype=torch.int32)
    qb, ok = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.bulk_insert(tk, tv, st, qb, q, q, ok, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.bulk_find(tk, tv, st, qb, q, ok, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.hash_words(q, 4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.bloom_insert(torch.zeros((4, 2), dtype=torch.int32), qb, q.repeat(1, 2), ok,
                          impl="cuda")


# --------------------------------------------------------------------------
# hash probe: bulk_insert_arrivals / bulk_find_arrivals
# --------------------------------------------------------------------------

def _table(rng, nb, bsz, lk, lv, key_lo, nfill, read_bits):
    """A table populated by the JAX oracle, with read flags in the status."""
    tk = jnp.zeros((nb, bsz, lk), jnp.uint32)
    tv = jnp.zeros((nb, bsz, lv), jnp.uint32)
    st = jnp.zeros((nb, bsz), jnp.uint32)
    qb = jnp.asarray(rng.integers(0, nb, nfill).astype(np.int32))
    qk = jnp.asarray(_u32(rng, (nfill, lk), key_lo, key_lo + 40))
    qv = jnp.asarray(_u32(rng, (nfill, lv)))
    tk, tv, st, _ = jref.hash_probe_insert_ref(tk, tv, st, qb, qk, qv,
                                               jnp.ones(nfill, bool), jref.MODE_SET)
    if read_bits:
        st = st | (jnp.asarray(_u32(rng, (nb, bsz), 0, 1 << 20)) << 7)
    return tuple(np.asarray(a) for a in (tk, tv, st))


INSERT_CASES = {
    # nb, B, Lk, Lv, m, key_lo, prefill, read bits
    "dups": (4, 16, 1, 1, 48, 0, 20, False),
    "block_fills": (2, 8, 1, 2, 40, 0, 6, False),
    "lk2": (8, 16, 2, 1, 64, 0, 30, False),
    "keys_ge_2_31": (4, 16, 1, 1, 48, (1 << 31) + 5, 20, False),
    "read_bits": (4, 16, 1, 1, 48, 0, 25, True),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", [jref.MODE_SET, jref.MODE_ADD, jref.MODE_KEEP])
@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_bulk_insert_arrivals_matches_jax(impl, mode, case):
    nb, bsz, lk, lv, m, key_lo, nfill, rbits = INSERT_CASES[case]
    rng = np.random.default_rng(len(case) * 3 + mode)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, key_lo, nfill, rbits)
    # keys drawn from the prefill's range: duplicates in the batch and hits
    seg = np.concatenate([rng.integers(0, nb, (m, 1)).astype(np.uint32),
                          _u32(rng, (m, lk), key_lo, key_lo + 40),
                          _u32(rng, (m, lv))], axis=1)
    valid = rng.random(m) < 0.9
    want = jops.bulk_insert_arrivals(*map(jnp.asarray, (tk, tv, st, seg, valid)), mode,
                                     impl=impl)
    got = tops.bulk_insert_arrivals(*map(_t, (tk, tv, st, seg, valid)), mode,
                                    impl="torch")
    for w, g, name in zip(want, got, ("tkeys", "tvals", "status", "success")):
        _same(w, g, name)
    if case == "block_fills":
        assert not bool(got[3][_t(valid)].all())     # some arrivals found no room


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", ["present_absent", "read_bits", "lk2"])
def test_bulk_find_arrivals_matches_jax(impl, case):
    nb, bsz, lk, lv = (8, 16, 2, 2) if case == "lk2" else (4, 16, 1, 1)
    rng = np.random.default_rng(len(case))
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0, 40, case == "read_bits")
    m = 64    # keys in [0, 80): about half were inserted somewhere
    seg = np.concatenate([rng.integers(0, nb, (m, 1)).astype(np.uint32),
                          _u32(rng, (m, lk), 0, 80)], axis=1)
    valid = rng.random(m) < 0.9
    jf, jv = jops.bulk_find_arrivals(*map(jnp.asarray, (tk, tv, st, seg, valid)),
                                     impl=impl)
    tf, tv_ = tops.bulk_find_arrivals(*map(_t, (tk, tv, st, seg, valid)), impl="torch")
    _same(jf, tf, "found")
    _same(jv, tv_, "values")


def test_insert_plain_equals_sequential_oracle():
    """The vectorized plain insert equals the port's sequential oracle."""
    rng = np.random.default_rng(11)
    for mode in (tref.MODE_SET, tref.MODE_ADD, tref.MODE_KEEP):
        tk, tv, st = _table(rng, 4, 8, 1, 1, 0, 12, True)
        m = 40
        qb = rng.integers(0, 4, m).astype(np.int32)
        qk = _u32(rng, (m, 1), 0, 30)
        qv = _u32(rng, (m, 1))
        valid = rng.random(m) < 0.9
        args = list(map(_t, (tk, tv, st, qb, qk, qv, valid)))
        want = tref.hash_probe_insert_ref(*args, mode)
        got = tops.bulk_insert(*args, mode, impl="torch")
        for w, g in zip(want, got):
            assert torch.equal(w, g)


# --------------------------------------------------------------------------
# hash probe: the column front ends bulk_insert / bulk_find
# --------------------------------------------------------------------------

def _columns(rng, case):
    nb, bsz, lk, lv, m, key_lo, nfill, rbits = INSERT_CASES[case]
    tk, tv, st = _table(rng, nb, bsz, lk, lv, key_lo, nfill, rbits)
    qb = rng.integers(0, nb, m).astype(np.int32)
    qk = _u32(rng, (m, lk), key_lo, key_lo + 40)
    qv = _u32(rng, (m, lv))
    valid = rng.random(m) < 0.9
    return tk, tv, st, qb, qk, qv, valid


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", [jref.MODE_SET, jref.MODE_ADD, jref.MODE_KEEP])
@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_bulk_insert_matches_jax(impl, mode, case):
    """Duplicates, full blocks, Lk=2, keys >= 2**31, read flags; batches
    below the Pallas ``default_q_cap`` (the whole batch here)."""
    rng = np.random.default_rng(len(case) * 5 + mode)
    cols = _columns(rng, case)
    want = jax.jit(jops.bulk_insert, static_argnums=7, static_argnames="impl")(
        *map(jnp.asarray, cols), mode, impl=impl)
    got = tops.bulk_insert(*map(_t, cols), mode, impl="torch")
    for w, g, name in zip(want, got, ("tkeys", "tvals", "status", "success")):
        _same(w, g, name)
    oracle = tref.hash_probe_insert_ref(*map(_t, cols), mode)
    for o, g in zip(oracle, got):
        assert torch.equal(o, g)
    if case == "block_fills":
        assert not bool(got[3][_t(cols[6])].all())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", ["present_absent", "read_bits", "lk2"])
def test_bulk_find_matches_jax(impl, case):
    nb, bsz, lk, lv = (8, 16, 2, 2) if case == "lk2" else (4, 16, 1, 1)
    rng = np.random.default_rng(len(case) + 100)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0, 40, case == "read_bits")
    m = 64
    qb = rng.integers(0, nb, m).astype(np.int32)
    qk = _u32(rng, (m, lk), 0, 80)
    qk[: m // 2] = tk[qb[: m // 2], rng.integers(0, bsz, m // 2)]   # stored keys
    valid = rng.random(m) < 0.9
    jf, jv = jax.jit(jops.bulk_find, static_argnames="impl")(
        *map(jnp.asarray, (tk, tv, st, qb, qk, valid)), impl=impl)
    tf, tv_ = tops.bulk_find(*map(_t, (tk, tv, st, qb, qk, valid)), impl="torch")
    _same(jf, tf, "found")
    _same(jv, tv_, "values")
    assert 0 < int(tf.sum()) < int(_t(valid).sum())


# --------------------------------------------------------------------------
# blocked Bloom filter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,nseg", [(1, 1), (7, 3), (200, 5), (1000, 64), (333, 333)])
def test_seg_exclusive_or_scan_matches_jax(m, nseg):
    rng = np.random.default_rng(m + nseg)
    words = _u32(rng, (m, 2))
    heads = np.zeros(m, bool)
    heads[0] = True
    heads[rng.choice(m, nseg - 1, replace=False) if nseg > 1 else []] = True
    want = jax.jit(jops.seg_exclusive_or_scan)(jnp.asarray(words), jnp.asarray(heads))
    _same(want, tops.seg_exclusive_or_scan(_t(words), _t(heads)), "scan")


BLOOM_CASES = [
    # nblocks, m, distinct items, fraction valid
    (16, 64, 20, 0.9), (4, 100, 100, 1.0), (64, 500, 80, 0.8), (1, 30, 5, 1.0),
]


def _bloom_batch(rng, nb, m, distinct, frac, k=4):
    """Items drawn from a small pool (in-batch duplicates), their blocks
    and bit words, and a filter with some bits already set."""
    pool = _u32(rng, (distinct, 2))
    items = pool[rng.integers(0, distinct, m)]
    words = np.asarray(jax.jit(lambda a: jref.bloom_words_ref(jh.double_hash(a, k, 64), k))(
        jnp.asarray(items)))
    qb = (items[:, 0] % nb).astype(np.int32)
    filt = _u32(rng, (nb, 2)) & _u32(rng, (nb, 2)) & _u32(rng, (nb, 2))
    return filt, qb, words, rng.random(m) < frac


@pytest.mark.parametrize("impl", ["jnp", "pallas", "oracle"])
@pytest.mark.parametrize("nb,m,distinct,frac", BLOOM_CASES)
def test_bloom_insert_matches_jax(impl, nb, m, distinct, frac):
    rng = np.random.default_rng(nb * 7 + m)
    args = _bloom_batch(rng, nb, m, distinct, frac)
    jw, ja = jax.jit(jops.bloom_insert, static_argnames="impl")(*map(jnp.asarray, args),
                                                                  impl=impl)
    tw, ta = tops.bloom_insert(*map(_t, args), impl="torch")
    _same(jw, tw, "filter words")
    _same(ja, ta, "already present")
    rw, ra = tref.bloom_insert_ref(*map(_t, args))
    assert torch.equal(rw, tw) and torch.equal(ra, ta)
    if distinct < m:                                # first-inserter-wins shows
        assert bool(ta.any()) and not bool(ta[_t(args[3])].all())


@pytest.mark.parametrize("nb,m,distinct,frac", BLOOM_CASES)
def test_bloom_find_matches_jax(nb, m, distinct, frac):
    rng = np.random.default_rng(nb + m)
    args = _bloom_batch(rng, nb, m, distinct, frac)
    _same(jax.jit(jops.bloom_find)(*map(jnp.asarray, args)),
          tops.bloom_find(*map(_t, args)), "present")


@pytest.mark.parametrize("m,lanes,k", [(1, 1, 1), (100, 1, 4), (1000, 2, 4),
                                       (777, 3, 7), (64, 2, 64)])
def test_hash_words_matches_jax(m, lanes, k):
    rng = np.random.default_rng(m * lanes + k)
    x = _u32(rng, (m, lanes))
    x[:1] = 0xFFFFFFFF                              # wrap at 2**32
    got = tops.hash_words(_t(x), k, impl="torch")
    _same(jax.jit(jbk.hash_words, static_argnums=1)(jnp.asarray(x), k), got,
          "Pallas hash_words")
    words = jax.jit(lambda a: jref.bloom_words_ref(jh.double_hash(a, k, 64), k))
    _same(words(jnp.asarray(x)), got, "bloom_words_ref(double_hash)")
    assert torch.equal(tref.bloom_words_ref(th.double_hash(_t(x), k, 64), k), got)


@pytest.mark.parametrize("m", [1, 100, 1500])
def test_membership_matches_jax(m):
    rng = np.random.default_rng(m)
    words = _u32(rng, (m, 2)) & _u32(rng, (m, 2)) & _u32(rng, (m, 2))
    prior = _u32(rng, (m, 2))
    prior[: m // 2] |= words[: m // 2]
    valid = rng.random(m) < 0.9
    _same(jax.jit(jbk.membership)(*map(jnp.asarray, (prior, words, valid))),
          tbk.membership_plain(*map(_t, (prior, words, valid))), "membership")
