"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test needs a CUDA device and skips without one (the
check runs inside the fixture, so every worker collects the same tests).
Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Every output of the integer kernels is integer, so their tolerance is 0:
bit equality.  Flash attention is float: float32 at ``atol = rtol = 3e-5``
(the kernel's online softmax sums in another order than the plain
version's whole-row softmax), bf16 within one bf16 ulp of each element
(``atol = 1e-4``, ``rtol = 2**-7``: both versions accumulate in float32 and
round once, so an element moves by at most one ulp of its own size).
With ``probs_bf16`` both sides round each probability to bf16 against
their own running max, so the gate gains ``2**-8`` of the
attention-weighted mean of ``|V|``.  The recurrent mixers' scans:
``rwkv_scan`` and ``mamba_scan``'s sequential route (calls shorter than a
chunk) round each state update as the plain step does, so their final
states are bit-identical, and their outputs sum in another order, within
``SCAN_REL_L2`` relative L2; ``mamba_scan``'s chunked route (the SSD form
in 3xTF32 on the tensor cores) rounds otherwise, so its output and its
final state are both held at ``SCAN_REL_L2``.  Each mamba call must launch
the kernel of the route its shape picks (``mamba_scan``, the chunked one,
or ``mamba_scan_seq``) once, and no other.  The attention backward
(``flash_attention_bwd``) is held against autograd through the plain
version by relative L2 (``BWD_REL``), one launch a call, repeatable bit for
bit, and its planted faults must break it; with ``probs_bf16`` against the
plain version's gradient (its roundings passing the gradient through), the
flag ignored breaking it; the MoE layer's backward through the wire
kernels bit for bit against the plain versions; the kernel routes without
a backward (the scans) must refuse a gradient.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import binning, bloom_kernel, build, hash_probe, ref, ssm_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    torch.cuda.synchronize()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    assert torch.equal(a.cpu(), b.cpu())


def _i32(rng, shape, lo=-(1 << 31), hi=1 << 31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("n,nbins", [(0, 3), (1, 1), (31, 2), (1000, 5), (5000, 1023),
                                     (70000, 2), (9000, 1024), (50000, 4096),
                                     (300000, 1 << 20), (0, 5000)])
def test_bin_offsets_kernel(dev, n, nbins):
    rng = np.random.default_rng(n + nbins)
    bins = _i32(rng, (n,), 0, nbins).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    before = binning._BIN_OFFSETS.launches, binning._BIN_CSR.launches
    _eq(binning.bin_offsets(bins, nbins, valid),
        binning.bin_offsets_plain(bins, nbins, valid))
    # past one launch's bins: the bin_csr route
    want = (0, 1) if nbins > binning.LAUNCH_BINS else (1, 0)
    assert (binning._BIN_OFFSETS.launches - before[0],
            binning._BIN_CSR.launches - before[1]) == want


#: bin_offsets' one pass: ballots at one bin, matches above; the look-back
#: a warp per bin up to 4 bins (the invalid one included), a lane per bin above
@pytest.mark.parametrize("n,nbins,vfrac", [
    (4095, 1, 0.5), (4096, 1, 1.0), (4097, 1, 0.5), (4095, 2, 0.5), (4097, 3, 0.5),
    (12289, 3, 0.5), (12289, 4, 0.5),
    (8191, 31, 0.5), (8193, 32, 0.5), (12289, 33, 1.0), (40000, 1023, 0.5),
    (1 << 22, 1, 0.9), (1 << 22, 2, 0.9), (1 << 22, 33, 0.9), (50000, 1, 0.0),
    (50000, 3, 0.0), (0, 2, 0.5), (1, 1, 0.0)])
def test_bin_offsets_tiles(dev, n, nbins, vfrac):
    """The one pass at its tile edges (4096 items a tile), 2**22 items (more
    tiles than resident CTAs), all or no items valid; ranked by ballots at
    one bin, by matches above: one launch each."""
    rng = np.random.default_rng(n + nbins)
    bins = _i32(rng, (n,), 0, nbins)
    if n > 10000:                                   # runs of equal bins, as at one rank
        bins[: n // 2] = torch.sort(bins[: n // 2]).values
    bins, valid = bins.to(dev), torch.from_numpy(rng.random(n) < vfrac).to(dev)
    before = binning._BIN_OFFSETS.launches
    _eq(binning.bin_offsets(bins, nbins, valid),
        binning.bin_offsets_plain(bins, nbins, valid))
    assert binning._BIN_OFFSETS.launches - before == 1


def test_bin_offsets_back_to_back(dev):
    """Calls with other bin counts reuse the scratch of the one before: a
    status word left over must never be read as this call's."""
    rng = np.random.default_rng(7)
    n = 300000
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for nbins in (3, 2, 33, 1, 3, 1023, 3):
        bins = _i32(rng, (n,), 0, nbins).to(dev)
        got = binning.bin_offsets(bins, nbins, valid)
        _eq(got, binning.bin_offsets_plain(bins, nbins, valid))


def _wire(rng, n, nflows, nprocs, rnd, drop, wmax=None):
    """A pack_rows call as a commit makes it: flows of their own row
    widths (``wmax`` wider than some), ranks per (dest, flow) bucket from
    one binning pass, the round's window of each flow still retrying, the
    live flows' segments laid out in order; at one rank the flows are
    concatenated in batch order.  ``drop`` cuts the buffer short, so
    rows past its end drop (one may straddle it).  ``wmax``: rows that
    wide, the flows' widths from half of it up to it."""
    if wmax is not None:
        roww = rng.integers(max(1, wmax // 2), wmax + 1, nflows)
    else:
        roww = rng.integers(1, 7, nflows)
        wmax = int(roww.max()) + int(rng.integers(0, 2))
    flow = np.sort(rng.integers(0, nflows, n)) if nprocs == 1 else rng.integers(0, nflows, n)
    dest = rng.integers(0, nprocs, n)
    valid = rng.random(n) < 0.9
    caps = np.maximum(1, rng.integers(n // (4 * nprocs * nflows) + 1,
                                      n // (nprocs * nflows) + 2, nflows))
    rounds = rng.integers(1, 4, nflows)
    rounds[0] = rnd + 1                                  # one flow ships in this round
    live = rounds > rnd
    seg = np.where(live, caps * roww, 0)
    woff = np.cumsum(seg) - seg
    wtot = int(seg.sum())
    total = nprocs * wtot - (int(rng.integers(1, wtot)) if drop else 0)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (dest, flow)]
    offs = binning.bin_offsets_plain(t[0] * nflows + t[1], nprocs * nflows,
                                     torch.from_numpy(valid))[1]
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n, wmax)).astype(np.int32))
    tabs = [torch.from_numpy(a.astype(np.int32)) for a in (woff, roww, caps, rounds)]
    return (rows, t[0], t[1], offs, torch.from_numpy(valid), rnd, *tabs, wtot, total)


@pytest.mark.parametrize("n,nflows,nprocs,rnd,drop,wmax", [
    (1000, 1, 1, 0, False, None), (5000, 3, 1, 1, False, None), (70001, 8, 1, 2, True, None),
    (1 << 20, 2, 1, 0, False, None), (5000, 5, 8, 0, True, None),
    (70001, 8, 8, 1, False, None), (300000, 4, 8, 2, True, None),
    (5000, 3, 1, 0, False, 8), (70001, 4, 8, 1, True, 31), (4097, 2, 1, 0, True, 32),
    (70001, 5, 8, 2, False, 33), (30000, 3, 8, 0, True, 65), (100000, 1, 1, 0, False, 65)])
def test_pack_rows_wire(dev, n, nflows, nprocs, rnd, drop, wmax):
    """Flows of other widths, retry windows, dropped rows; consecutive
    slots at one rank (P=1), random destinations at P=8; rows up to 7
    words wide, and 8, 31, 32, 33 and 65 words (one row or less a lane
    step, one wrap at most)."""
    args = _wire(np.random.default_rng(n + nflows + rnd), n, nflows, nprocs, rnd, drop,
                 wmax=wmax)
    on = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    _eq(binning.pack_rows(*on), binning.pack_rows_plain(*on))


@pytest.mark.parametrize("n,nbins", [(0, 4), (1, 1), (5000, 3), (70001, 1024), (200000, 5000),
                                     (300000, 1 << 20), (9000, 1 << 24)])
def test_bin_csr_kernel(dev, n, nbins):
    """The stable CSR by bin, bins outside range and invalid items last; a
    strided bins column."""
    rng = np.random.default_rng(n + nbins)
    wide = torch.from_numpy(rng.integers(-2, min(nbins + 2, 1 << 31), (n, 3)).astype(np.int32))
    if nbins > 1 << 20:                              # a few crowded bins among many
        wide[:, 0] = torch.from_numpy(rng.integers(0, 50, n) * 12345).to(torch.int32)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    col = wide.to(dev)[:, 0]
    _eq(binning.bin_csr(col, nbins, valid), binning.bin_csr_plain(col, nbins, valid))


#: bin_csr's tiles hold 8192 words
@pytest.mark.parametrize("n,nbins,vfrac,stride", [
    (8191, 1025, 0.9, 1), (8192, 1025, 0.9, 1), (8193, 1025, 0.9, 3), (24577, 1, 0.9, 1),
    (40000, 1, 0.5, 2), (50000, 1025, 0.0, 1), (50000, 1 << 20, 0.0, 3),
    (1 << 19, 1 << 20, 0.9, 3), (2 * 132 * 8192 - 1, 1 << 20, 0.9, 1),
    ((1 << 22) + 1, 1 << 20, 0.9, 3), (3 << 20, 1025, 0.9, 1)])
def test_bin_csr_tiles(dev, n, nbins, vfrac, stride):
    """The CSR at its tile edges, all invalid, bins in a strided column (the
    exchange segment's block lane), 1, 1025 and 2**20 bins, up to 512
    tiles; one crowded bin in a third of the items.  One launch of the
    wrapper each."""
    rng = np.random.default_rng(n + nbins + stride)
    wide = _i32(rng, (n, stride), -1, nbins + 1)
    wide[: n // 3, 0] = nbins // 2
    col, valid = wide.to(dev)[:, 0], torch.from_numpy(rng.random(n) < vfrac).to(dev)
    before = binning._BIN_CSR.launches
    _eq(binning.bin_csr(col, nbins, valid), binning.bin_csr_plain(col, nbins, valid))
    assert binning._BIN_CSR.launches - before == 1


def test_multi_bin_offsets_many_ranks(dev):
    """P x F = 256 x 5 composite bins: past one launch's bins."""
    rng = np.random.default_rng(256)
    n, nprocs, nflows = 200000, 256, 5
    dest = _i32(rng, (n,), 0, nprocs).to(dev)
    flow = _i32(rng, (n,), 0, nflows).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    got = ops.multi_bin_offsets(dest, flow, nprocs, nflows, valid, impl="cuda")
    _eq(got, ops.multi_bin_offsets(dest, flow, nprocs, nflows, valid, impl="torch"))
    assert tuple(got[0].shape) == (nprocs, nflows)


@pytest.mark.parametrize("n,rnd", [(0, 0), (37, 0), (4096, 1), (50001, 2)])
def test_pack_rows_kernel(dev, n, rnd):
    rng = np.random.default_rng(n + rnd)
    nprocs, caps, roww = 3, [5, 9], [2, 4]
    flow = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    bins = _i32(rng, (n,), 0, nprocs)
    valid = torch.from_numpy(rng.random(n) < 0.9)
    # unique ranks per (dest, flow) bucket, as the exchange's binning gives
    offs = binning.bin_offsets_plain(bins * 2 + flow, nprocs * 2, valid)[1]
    rows = _i32(rng, (n, 4))
    wtot = sum(c * w for c, w in zip(caps, roww))
    tables = [torch.tensor(t, dtype=torch.int32) for t in
              ([0, caps[0] * roww[0]], roww, caps, [3, 2])]
    args = [t.to(dev) for t in (rows, bins, flow, offs, valid)]
    tabs = [t.to(dev) for t in tables]
    out = binning.pack_rows(*args, rnd, *tabs, wtot, nprocs * wtot)
    _eq(out, binning.pack_rows_plain(*args, rnd, *tabs, wtot, nprocs * wtot))


@pytest.mark.parametrize("total,m,w", [(0, 0, 1), (100, 0, 2), (1000, 300, 1),
                                       (4099, 1300, 3)])
def test_place_rows_kernel(dev, total, m, w):
    rng = np.random.default_rng(total + m)
    dst = _i32(rng, (total,)).to(dev)
    # disjoint rows; some start past the end (drop), one may straddle it
    starts = rng.permutation(-(-(total + 50) // w))[:m] * w
    slots = torch.from_numpy(starts.astype(np.int32)).to(dev)
    rows = _i32(rng, (m, w)).to(dev)
    _eq(binning.place_rows(dst, slots, rows), binning.place_rows_plain(dst, slots, rows))


def _table(rng, nb, bsz, lk, lv, fill):
    tk = _i32(rng, (nb, bsz, lk), 0, 50)
    tv = _i32(rng, (nb, bsz, lv))
    st = torch.from_numpy(np.where(rng.random((nb, bsz)) < fill, 2, 0).astype(np.int32))
    st |= _i32(rng, (nb, bsz), 0, 1 << 20) << 7     # read flags ride along
    return tk, tv, st


@pytest.mark.parametrize("mode", [ref.MODE_SET, ref.MODE_ADD, ref.MODE_KEEP])
@pytest.mark.parametrize("nb,bsz,lk,lv,m", [(4, 64, 1, 1, 0), (8, 64, 1, 1, 3000),
                                            (16, 40, 2, 3, 500), (1, 64, 1, 1, 200)])
def test_insert_arrivals_kernel(dev, mode, nb, bsz, lk, lv, m):
    rng = np.random.default_rng(nb * 7 + m + mode)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.5)
    seg = torch.cat([_i32(rng, (m, 1), 0, nb), _i32(rng, (m, lk), 0, 50),
                     _i32(rng, (m, lv)), _i32(rng, (m, 1))], dim=1)
    valid = torch.from_numpy(rng.random(m) < 0.9)
    args = [t.to(dev) for t in (tk, tv, st)]
    view = seg.to(dev)[:, :1 + lk + lv]          # strided rows, as in the exchange
    v = valid.to(dev)
    _eq(hash_probe.insert_arrivals(*args, view, v, mode),
        hash_probe.insert_arrivals_plain(*args, view, v, mode))


@pytest.mark.parametrize("nb,bsz,lk,lv,m", [(4, 64, 1, 1, 0), (8, 64, 1, 2, 3000),
                                            (16, 33, 2, 1, 700)])
def test_find_arrivals_kernel(dev, nb, bsz, lk, lv, m):
    rng = np.random.default_rng(nb + m)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.7)
    seg = torch.cat([_i32(rng, (m, 1), 0, nb), _i32(rng, (m, lk), 0, 50),
                     _i32(rng, (m, 1))], dim=1)
    valid = torch.from_numpy(rng.random(m) < 0.9)
    args = [t.to(dev) for t in (tk, tv, st)]
    view = seg.to(dev)[:, :1 + lk]
    v = valid.to(dev)
    _eq(hash_probe.find_arrivals(*args, view, v),
        hash_probe.find_arrivals_plain(*args, view, v))


# B, Lk, Lv, key range: one block takes 5000 arrivals (157 steps of 32)
CROWDED_CASES = [(33, 1, 1, 60), (128, 2, 1, 200), (200, 1, 2, 300), (64, 32, 32, 90)]


@pytest.mark.parametrize("front", ["arrivals", "columns"])
@pytest.mark.parametrize("mode", [ref.MODE_SET, ref.MODE_ADD, ref.MODE_KEEP])
@pytest.mark.parametrize("bsz,lk,lv,key_hi", CROWDED_CASES)
def test_insert_crowded_block(dev, front, mode, bsz, lk, lv, key_hi):
    rng = np.random.default_rng(bsz + lk + mode)
    nb, m = 6, 6000
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.3)
    tk = tk % key_hi
    qb = _i32(rng, (m,), 0, nb)
    qb[rng.permutation(m)[:5000]] = 2               # one block takes 5000 arrivals
    wide = torch.cat([qb[:, None], _i32(rng, (m, lk), 0, key_hi), _i32(rng, (m, lv)),
                      _i32(rng, (m, 1))], dim=1).to(dev)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    args = [t.to(dev) for t in (tk, tv, st)]
    if front == "arrivals":
        seg = wide[:, :1 + lk + lv]
        got = hash_probe.insert_arrivals(*args, seg, valid, mode)
        want = hash_probe.insert_arrivals_plain(*args, seg, valid, mode)
    else:
        cols = (wide[:, 0].contiguous(), wide[:, 1:1 + lk], wide[:, 1 + lk:1 + lk + lv])
        got = hash_probe.insert(*args, *cols, valid, mode)
        want = hash_probe.insert_plain(*args, *cols, valid, mode)
    _eq(got, want)
    ok = got[3].cpu()
    assert bool(ok.any()) and not bool(ok.all())     # hits, claims and a full block
    for old, new in zip(args, got[:3]):               # out of place: the input stays
        assert new.data_ptr() != old.data_ptr()


@pytest.mark.parametrize("nb,m", [(8, 4000), (4096, 1000)], ids=["dense", "sparse"])
@pytest.mark.parametrize("front", ["arrivals", "columns"])
def test_find_block_out_of_range(dev, front, nb, m):
    """A valid query whose block lies outside [0, nb) finds nothing, on
    either route."""
    rng = np.random.default_rng(17)
    bsz, lk, lv = 64, 2, 2
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.7)
    qb = _i32(rng, (m,), 0, nb)
    qk = tk[qb.long(), torch.from_numpy(rng.integers(0, bsz, m))]   # stored keys: hits
    far = torch.from_numpy(rng.random(m) < 0.2)
    qb_far = torch.where(far, torch.where(qb % 2 == 0, -1 - qb, nb + qb), qb)
    valid = torch.from_numpy(rng.random(m) < 0.9)
    args = [t.to(dev) for t in (tk, tv, st)]
    qb_far, qb, qk, valid, far = (t.to(dev) for t in (qb_far, qb, qk, valid, far))
    if front == "arrivals":
        found, vals = hash_probe.find_arrivals(*args, torch.cat([qb_far[:, None], qk], 1),
                                               valid)
    else:
        found, vals = hash_probe.find(*args, qb_far, qk, valid)
    _eq((found, vals), hash_probe.find_plain(*args, qb, qk, valid & ~far))
    assert bool(found.any())


@pytest.mark.parametrize("nb,m", [(4096, 1000), (4096, 8191), (4096, 8192), (64, 5000)])
@pytest.mark.parametrize("front", ["arrivals", "columns"])
def test_find_routes(dev, front, nb, m):
    """Both find routes against the plain version: one warp per query below
    DENSE_QUERIES queries a block (no CSR), block-major from it."""
    rng = np.random.default_rng(nb + m)
    bsz, lk, lv = 40, 2, 2
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.6)
    qb = _i32(rng, (m,), 0, nb)
    qk = tk[qb.long(), torch.from_numpy(rng.integers(0, bsz, m))]
    qk[::2] = _i32(rng, (m - m // 2, lk), 0, 50)       # half: keys from the table's range
    valid = torch.from_numpy(rng.random(m) < 0.9)
    args = [t.to(dev) for t in (tk, tv, st)]
    qb, qk, valid = qb.to(dev), qk.to(dev), valid.to(dev)
    before = binning._BIN_CSR.launches
    if front == "arrivals":
        got = hash_probe.find_arrivals(*args, torch.cat([qb[:, None], qk], 1), valid)
    else:
        got = hash_probe.find(*args, qb, qk, valid)
    _eq(got, hash_probe.find_plain(*args, qb, qk, valid))
    assert binning._BIN_CSR.launches - before == int(m >= hash_probe.DENSE_QUERIES * nb)


# column front ends: the local-promise path of the hash map
COLUMN_CASES = [
    # nb, B, Lk, Lv, m, key range
    (4, 16, 1, 1, 48, 50), (2, 8, 1, 2, 40, 50), (8, 16, 2, 1, 64, 50),
    (4, 64, 1, 1, 0, 50), (16, 40, 2, 3, 3000, 200), (1, 64, 1, 1, 200, 100),
]


def _columns(rng, m, lk, lv, nb, key_hi, dev):
    """qblock, strided qkeys/qvals views of one wider array, qvalid."""
    wide = torch.cat([_i32(rng, (m, lk), 0, key_hi), _i32(rng, (m, lv)),
                      _i32(rng, (m, 1))], dim=1).to(dev)
    qblock = _i32(rng, (m,), 0, nb).to(dev)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    return qblock, wide[:, :lk], wide[:, lk:lk + lv], valid


@pytest.mark.parametrize("mode", [ref.MODE_SET, ref.MODE_ADD, ref.MODE_KEEP])
@pytest.mark.parametrize("nb,bsz,lk,lv,m,key_hi", COLUMN_CASES)
def test_insert_kernel(dev, mode, nb, bsz, lk, lv, m, key_hi):
    rng = np.random.default_rng(nb * 5 + m + mode)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.5)
    if key_hi > 100:                                # keys >= 2**31 ride along
        tk ^= -(1 << 31)
    qb, qk, qv, valid = _columns(rng, m, lk, lv, nb, key_hi, dev)
    if key_hi > 100:
        qk = qk ^ -(1 << 31)
    args = [t.to(dev) for t in (tk, tv, st)]
    got = hash_probe.insert(*args, qb, qk, qv, valid, mode)
    _eq(got, hash_probe.insert_plain(*args, qb, qk, qv, valid, mode))
    if m and m <= 64:
        cpu = [t.cpu() for t in (*args, qb, qk, qv, valid)]
        _eq(tuple(g.cpu() for g in got), ref.hash_probe_insert_ref(*cpu, mode))


@pytest.mark.parametrize("nb,bsz,lk,lv,m,key_hi", COLUMN_CASES)
def test_find_kernel(dev, nb, bsz, lk, lv, m, key_hi):
    rng = np.random.default_rng(nb + m)
    tk, tv, st = _table(rng, nb, bsz, lk, lv, 0.7)
    qb, qk, _, valid = _columns(rng, m, lk, lv, nb, key_hi, dev)
    args = [t.to(dev) for t in (tk, tv, st)]
    # the kernel reads qblock only for valid queries
    junk = torch.where(valid, qb, 1 << 30)
    _eq(hash_probe.find(*args, junk, qk, valid), hash_probe.find_plain(*args, qb, qk, valid))


@pytest.mark.parametrize("m,lanes,k", [(0, 2, 4), (1, 1, 1), (1000, 1, 4), (4099, 2, 4),
                                       (70000, 3, 7), (513, 2, 64)])
def test_hash_words_kernel(dev, m, lanes, k):
    rng = np.random.default_rng(m + lanes + k)
    wide = _i32(rng, (m, lanes + 1)).to(dev)
    view = wide[:, :lanes]                          # strided rows
    _eq(bloom_kernel.hash_words(view, k), bloom_kernel.hash_words_plain(view, k))


@pytest.mark.parametrize("m", [0, 1, 37, 5000, 100003])
def test_membership_kernel(dev, m):
    rng = np.random.default_rng(m)
    words = _i32(rng, (m, 2)) & _i32(rng, (m, 2)) & _i32(rng, (m, 2))
    prior = _i32(rng, (m, 2))
    prior[: m // 2] |= words[: m // 2]               # half present
    valid = torch.from_numpy(rng.random(m) < 0.9)
    args = [t.to(dev) for t in (prior, words, valid)]
    got = bloom_kernel.membership(*args)
    _eq(got, bloom_kernel.membership_plain(*args))
    if m > 10:
        assert bool(got.any()) and not bool(got.all())


@pytest.mark.parametrize("m,lanes", [(0, 3), (1, 1), (37, 4), (5000, 2), (100003, 4)])
def test_row_mix_kernel(dev, m, lanes):
    rng = np.random.default_rng(m + lanes)
    wide = _i32(rng, (m, lanes + 2))
    wide[::5] = 0                                    # all-zero rows hash to 0
    wide = wide.to(dev)
    view = wide[:, :lanes]                           # rows at a row stride
    got = binning.row_mix(view)
    _eq(got, binning.row_mix_plain(view))
    _eq(binning.row_mix(view.contiguous()), got)
    assert not bool(got[::5].any())


@pytest.mark.parametrize("n,rnd", [(0, 0), (37, 0), (4096, 1), (50001, 2)])
def test_ragged_slots_kernel(dev, n, rnd):
    rng = np.random.default_rng(n + rnd + 1)
    nprocs, caps, roww = 3, [5, 9], [2, 4]
    flow = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    bins = _i32(rng, (n,), 0, nprocs)
    valid = torch.from_numpy(rng.random(n) < 0.9)
    offs = binning.bin_offsets_plain(bins * 2 + flow, nprocs * 2, valid)[1]
    wtot = sum(c * w for c, w in zip(caps, roww))
    tables = [torch.tensor(t, dtype=torch.int32) for t in
              ([0, caps[0] * roww[0]], roww, caps, [3, 2])]
    args = [t.to(dev) for t in (bins, flow, offs, valid)]
    tabs = [t.to(dev) for t in tables]
    got = binning.ragged_slots(*args, rnd, *tabs, wtot, nprocs * wtot)
    _eq(got, binning.ragged_slots_plain(*args, rnd, *tabs, wtot, nprocs * wtot))


@pytest.mark.parametrize("n,nbins", [(0, 3), (1, 1), (1000, 5), (70001, 1023),
                                     (50000, 20000), (3 << 20, 2), (100003, 1), (100003, 2),
                                     (100003, 3), (100003, 12288), (100003, 12289)])
def test_histogram_kernel(dev, n, nbins):
    rng = np.random.default_rng(n + nbins)
    bins = _i32(rng, (n,), -2, nbins + 2).to(dev)     # out-of-range bins are not counted
    valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    got = binning.histogram(bins, nbins, valid)
    _eq(got, binning.histogram_plain(bins, nbins, valid))
    assert int(got.sum()) == int((valid & (bins >= 0) & (bins < nbins)).sum())


def test_histogram_unaligned(dev):
    """Views that start off a 16-byte boundary: the item-by-item loads."""
    rng = np.random.default_rng(11)
    bins = _i32(rng, (70001,), -2, 5).to(dev)[3:]
    valid = torch.from_numpy(rng.random(70001) < 0.7).to(dev)[3:]
    _eq(binning.histogram(bins, 3, valid), binning.histogram_plain(bins, 3, valid))


def _close_attention(got, want, weighted=None):
    """``weighted``: the attention-weighted mean of |V| (probs_bf16 calls)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    g, w = got.float(), want.float()
    if weighted is not None:
        atol, rtol = (3e-5, 3e-5) if got.dtype == torch.float32 else (1e-4, 2.0 ** -7)
        diff = (g - w).abs()
        assert bool((diff <= atol + rtol * w.abs() + 2.0 ** -8 * weighted.float()).all()), \
            float(diff.max())
    elif got.dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)
    else:
        # both accumulate in float32 and round once: one bf16 ulp of the element
        torch.testing.assert_close(g, w, atol=1e-4, rtol=2.0 ** -7)


def _launched(dtype, call, probs_bf16=False):
    """Run ``call``; assert it launched the dtype's route once and the other
    never, and that the instance launched has the ``probs_bf16`` flag given."""
    bf16 = dtype == torch.bfloat16
    route, other = (fa._FLASH, fa._FLASH_F32) if bf16 else (fa._FLASH_F32, fa._FLASH)
    before, before_other = route.launches, other.launches
    out = call()
    assert route.launches == before + 1 and other.launches == before_other
    rows = fa.bf16_instances() if bf16 else fa.f32_instances()
    i = fa.last_instance["bf16" if bf16 else "f32"]
    assert 0 <= i < len(rows) and rows[i]["probs_bf16"] == probs_bf16, (i, rows)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", [
    (2, 4, 2, 64, 64, 16, True, 0),
    (1, 8, 2, 130, 130, 64, True, 0),        # odd T: a ragged last tile
    (2, 4, 1, 200, 200, 128, True, 0),       # MQA
    (1, 8, 4, 150, 150, 320, True, 0),       # gemma3-4b's head dim
    (1, 4, 2, 300, 300, 320, True, 96),      # window at D=320: skipped key tiles
    (1, 4, 2, 257, 257, 128, True, 64),      # window, odd T
    (2, 4, 2, 37, 201, 64, True, 0),         # suffix-aligned Tq < Tk
    (1, 4, 2, 1, 333, 128, True, 0),         # decode-like Tq = 1
    (1, 2, 2, 40, 40, 16, False, 0),         # non-causal, Tk % 64 != 0 (padded keys)
    (2, 4, 2, 50, 100, 64, False, 0),        # non-causal, Tq < Tk
    (1, 4, 2, 70, 70, 128, False, 32),       # non-causal window
    (1, 4, 4, 200, 200, 8, True, 0),         # D = 8: one box, mostly zero-filled
    (2, 8, 1, 333, 333, 72, True, 0),        # D = 72: two boxes, Hq/Hkv = 8
    (1, 8, 2, 190, 190, 256, True, 0),       # D = 256: 64-key tiles
    (1, 4, 1, 300, 300, 256, True, 100),     # window across a 64-key tile edge
    (1, 4, 4, 400, 400, 128, True, 200),     # window across a 128-key tile edge
    (1, 8, 2, 129, 385, 64, False, 0),       # non-causal, ragged Tq and Tk
    (2, 4, 4, 300, 77, 64, False, 0),        # cross-attention: non-causal Tq > Tk, ragged
    (1, 16, 16, 512, 128, 64, False, 0),     # seamless's cross call cut: Tq = 4 Tk
    (1, 4, 2, 1, 1, 64, True, 0)])           # one query, one key
def test_flash_attention_kernel(dev, dtype, b, hq, hkv, tq, tk, d, causal, window):
    g = torch.Generator(device="cpu").manual_seed(b * 1000 + tq + tk + d + window)
    q = torch.randn((b, hq, tq, d), generator=g).to(dev, dtype)
    k = torch.randn((b, hkv, tk, d), generator=g).to(dev, dtype)
    v = torch.randn((b, hkv, tk, d), generator=g).to(dev, dtype)
    got = _launched(dtype, lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
    _close_attention(got, fa.flash_attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", [
    (2, 8, 8, 200, 200, 192, True, 0),       # MLA's call: nope 128 + rope 64, V padded
    (2, 4, 4, 70, 70, 24, True, 0),          # reduced deepseek-v3's (nope 16 + rope 8)
    (1, 8, 2, 257, 257, 128, True, 64),      # GQA with a window
    (1, 4, 2, 150, 150, 320, False, 0)])     # the widest instance
def test_flash_attention_probs_bf16(dev, dtype, b, hq, hkv, tq, tk, d, causal, window):
    """``probs_bf16`` runs the flag's instances of each route once, and
    its output is not the route's output without the flag: float32 differs
    beyond the route's own gate, bf16 (P's rounding alone) not bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(b * 100 + tq + d)
    q = torch.randn((b, hq, tq, d), generator=g).to(dev, dtype)
    k = torch.randn((b, hkv, tk, d), generator=g).to(dev, dtype)
    v = torch.randn((b, hkv, tk, d), generator=g).to(dev, dtype)
    if d in (192, 24):
        v[..., d * 2 // 3:] = 0
    got = _launched(dtype, lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                                      probs_bf16=True), probs_bf16=True)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, probs_bf16=True)
    weighted = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal=causal,
                                        window=window)
    _close_attention(got, want, weighted)
    if d in (192, 24):
        assert not bool(got[..., d * 2 // 3:].any())
    unflagged = fa.flash_attention(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        diff = (got - unflagged).abs()
        assert not bool((diff <= 3e-5 + 3e-5 * unflagged.abs()).all()), float(diff.max())
    else:
        assert not torch.equal(got, unflagged)


def _strided_views(dev, dtype):
    """The model's head-split projections pass as views (no copy); the
    output is a (B, Hq, T, D) view of a (B, T, Hq, D) buffer."""
    g = torch.Generator(device="cpu").manual_seed(5)
    b, t, hq, hkv, d = 2, 96, 8, 2, 128
    x = torch.randn((b, t, (hq + 2 * hkv) * d), generator=g).to(dev, dtype)
    q = x[..., :hq * d].reshape(b, t, hq, d).transpose(1, 2)
    k = x[..., hq * d:(hq + hkv) * d].reshape(b, t, hkv, d).transpose(1, 2)
    v = x[..., (hq + hkv) * d:].reshape(b, t, hkv, d).transpose(1, 2)
    got = _launched(dtype, lambda: fa.flash_attention(q, k, v, causal=True))
    assert got.transpose(1, 2).is_contiguous()
    _close_attention(got, fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), causal=True))


def test_flash_attention_kernel_strided_views(dev):
    _strided_views(dev, torch.bfloat16)


def test_flash_attention_f32_kernel_strided_views(dev):
    _strided_views(dev, torch.float32)


def test_flash_attention_f32_kernel_phase_shape(dev):
    """chip_smoke.py's float32 kernel-phase call: 13 query tiles of 64 rows
    over 32 heads, causal, D = 128."""
    g = torch.Generator(device="cpu").manual_seed(777)
    q = torch.randn((2, 16, 777, 128), generator=g).to(dev)
    k = torch.randn((2, 4, 777, 128), generator=g).to(dev)
    v = torch.randn((2, 4, 777, 128), generator=g).to(dev)
    got = _launched(torch.float32, lambda: fa.flash_attention(q, k, v, causal=True))
    _close_attention(got, fa.flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("d", [72, 20, 13])
def test_flash_attention_f32_kernel_unaligned(dev, d):
    """Rows the kernel's 16-byte copies cannot read (a base 8 bytes off 16,
    or a head dim that is not a multiple of 4) are copied once, padded."""
    g = torch.Generator(device="cpu").manual_seed(d)
    b, t, hq, hkv = 1, 150, 4, 2
    x = torch.randn((b, hq + 2 * hkv, t, d + 2), generator=g).to(dev)
    q, k, v = x[:, :hq, :, 2:], x[:, hq:hq + hkv, :, 2:], x[:, hq + hkv:, :, 2:]
    assert q.data_ptr() % 16 == 8
    got = _launched(torch.float32, lambda: fa.flash_attention(q, k, v, causal=True, window=50))
    assert got.shape == (b, hq, t, d) and got.transpose(1, 2).is_contiguous()
    _close_attention(got, fa.flash_attention_plain(q, k, v, causal=True, window=50))


def test_flash_attention_f32_instances_spill_nothing(dev):
    """Every instance of the float32 route keeps its state in registers,
    and its shared memory fits a block."""
    rows = fa.f32_instances()
    for flag in (False, True):
        widths = [r["max_d"] for r in rows if r["probs_bf16"] == flag]
        assert widths == sorted(set(widths)) and widths[-1] == fa.MAX_HEAD_DIM
        assert all(w % 16 == 0 for w in widths)
    for r in rows:
        assert r["local_bytes"] == 0 and 0 < r["registers"] <= 255, r
        assert r["smem_bytes"] <= 232448, r


@pytest.mark.parametrize("d", [72, 20])
def test_flash_attention_kernel_unaligned(dev, d):
    """Operands TMA cannot read as they are (a base 8 bytes off 16, or a
    head dim that is not a multiple of 8) go through the wrapper's padded
    copy; the output keeps the head-merged layout."""
    g = torch.Generator(device="cpu").manual_seed(d)
    b, t, hq, hkv = 1, 150, 4, 2
    x = torch.randn((b, hq + 2 * hkv, t, d + 4), generator=g).to(dev, torch.bfloat16)
    q, k, v = x[:, :hq, :, 4:], x[:, hq:hq + hkv, :, 4:], x[:, hq + hkv:, :, 4:]
    assert q.data_ptr() % 16 == 8
    got = _launched(torch.bfloat16, lambda: fa.flash_attention(q, k, v, causal=True, window=50))
    assert got.shape == (b, hq, t, d) and got.transpose(1, 2).is_contiguous()
    _close_attention(got, fa.flash_attention_plain(q, k, v, causal=True, window=50))


def test_flash_attention_kernel_refuses(dev):
    """Shapes the kernel does not take raise; nothing falls back."""
    q = torch.zeros((1, 4, 8, 16), device=dev)
    k = torch.zeros((1, 2, 8, 16), device=dev)
    bad = [((q, k.bfloat16(), k), "want a 4-D"),
           ((q, k.cpu(), k), "want a 4-D"),
           ((q, k[:, :, :4], k[:, :, :4]), "see no key"),                 # causal Tq > Tk
           ((torch.zeros((1, 4, 8, 336), device=dev),) + (torch.zeros((1, 2, 8, 336),
                                                                      device=dev),) * 2,
            "head dim"),
           ((q, torch.zeros((1, 3, 8, 16), device=dev), torch.zeros((1, 3, 8, 16), device=dev)),
            "kv heads"),
           ((q.half(), k.half(), k.half()), "dtype"),
           ((q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3)), "contiguous")]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ops.flash_attention(*args, impl="cuda")


# -- the recurrent mixers' scans ---------------------------------------------

SCAN_REL_L2 = 1e-5


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


MAMBA_CASES = [  # (nb, t, nh, p, s, top): a dt down to -top a step; None: a in (-2, 0]
    (2, 1, 3, 64, 16, None), (2, 70, 5, 64, 64, None), (1, 33, 2, 32, 32, None),
    (1, 9, 2, 256, 128, None), (3, 40, 4, 7, 64, None),
    (2, 2048, 8, 64, 64, None), (1, 31, 4, 64, 64, None), (1, 32, 4, 64, 64, None),
    (1, 31, 4, 64, 64, 30.0), (2, 33, 4, 64, 64, 30.0), (1, 2048, 4, 64, 64, 30.0),
    (1, 100, 2, 128, 128, 30.0), (2, 77, 3, 64, 16, 0.01)]


@pytest.mark.parametrize("nb,t,nh,p,s,top", MAMBA_CASES, ids=[
    "-".join(map(str, case[:5])) + ("" if case[5] is None else f"-top{case[5]:g}")
    for case in MAMBA_CASES])
def test_mamba_scan_kernel(dev, nb, t, nh, p, s, top):
    """x, B and C as strided slices of one conv output, as ``mamba_apply``
    passes them; head widths 7-256, each d_state instance; T = 1 (decode),
    T = L - 1 (the sequential route), L, L + 1 and many chunks (the chunked
    route, 4-byte copies at head width 7); a dt down to -top a step
    (strong: -30; weak: -0.01)."""
    g = torch.Generator(device=dev).manual_seed(nb * 1000 + t * 10 + s)
    conv = F.silu(torch.randn((nb, t, nh * p + 2 * s), generator=g, device=dev))
    x = conv[..., :nh * p].reshape(nb, t, nh, p)
    b, c = conv[..., nh * p:nh * p + s], conv[..., nh * p + s:]
    dt = F.softplus(torch.randn((nb, t, nh), generator=g, device=dev))
    a = -2 * torch.rand(nh, generator=g, device=dev)
    if top is not None:
        a = a * (top / 2) / dt.max()
    h0 = 0.1 * torch.randn((nb, nh, s, p), generator=g, device=dev)
    before = build.launch_counts()
    y, h = ops.mamba_scan(x, dt, b, c, a, h0, impl="cuda")
    want_y, want_h = ssm_scan.mamba_scan_plain(x, dt, b, c, a, h0)
    torch.cuda.synchronize()
    chunked = ssm_scan.mamba_route(t, nh, p, s) > 0
    ran = {n: k - before[n] for n, k in build.launch_counts().items() if k != before[n]}
    assert ran == {"mamba_scan" if chunked else "mamba_scan_seq": 1}
    if chunked:
        assert h.shape == want_h.shape and _rel(h, want_h) <= SCAN_REL_L2
    else:
        assert torch.equal(h, want_h)
    assert y.shape == want_y.shape and _rel(y, want_y) <= SCAN_REL_L2


@pytest.mark.parametrize("nb,t,nh,k", [(2, 1, 3, 64), (2, 70, 4, 64), (1, 33, 2, 32),
                                       (3, 40, 5, 16), (2, 2048, 4, 64)])
def test_rwkv_scan_kernel(dev, nb, t, nh, k):
    g = torch.Generator(device=dev).manual_seed(nb * 1000 + t * 10 + k)
    r, key, v = (torch.randn((nb, t, nh, k), generator=g, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(-5 + torch.randn((nb, t, nh, k), generator=g, device=dev)))
    u = 0.1 * torch.randn((nh, k), generator=g, device=dev)
    s0 = torch.randn((nb, nh, k, k), generator=g, device=dev)
    before = ssm_scan._RWKV.launches
    out, s = ops.rwkv_scan(r, key, v, w, u, s0, impl="cuda")
    want_out, want_s = ssm_scan.rwkv_scan_plain(r, key, v, w, u, s0)
    torch.cuda.synchronize()
    assert ssm_scan._RWKV.launches == before + 1
    assert torch.equal(s, want_s)
    assert out.shape == want_out.shape and _rel(out, want_out) <= SCAN_REL_L2


def test_scan_kernels_refuse(dev):
    """Widths without an instance, layouts the kernels do not read, and
    CPU operands raise; nothing falls back."""
    def mamba(nb=1, t=4, nh=2, p=64, s=16):
        return [torch.zeros(shape, device=dev) for shape in
                ((nb, t, nh, p), (nb, t, nh), (nb, t, s), (nb, t, s), (nh,), (nb, nh, s, p))]
    x, dt, b, c, a, h0 = mamba()
    wide_c = torch.zeros((1, 4, 32), device=dev)[..., :16]          # other strides than b's
    split_x = torch.zeros((1, 4, 64, 2), device=dev).transpose(2, 3)   # (H, P) not contiguous
    bad = [(mamba(s=48), "d_state 48"), (mamba(p=300), "head 300"),
           ([x, dt, b, wide_c, a, h0], "equal strides"),
           ([split_x, dt, b, c, a, h0], "must be contiguous"),
           ([x, dt.cpu(), b, c, a, h0], "on cuda"), ([x.double(), dt, b, c, a, h0], "float32")]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ops.mamba_scan(*args, impl="cuda")
    r = torch.zeros((1, 4, 2, 128), device=dev)
    u, s0 = torch.zeros((2, 128), device=dev), torch.zeros((1, 2, 128, 128), device=dev)
    with pytest.raises(ValueError, match="head 128"):
        ops.rwkv_scan(r, r, r, r, u, s0, impl="cuda")
    r = torch.zeros((1, 4, 2, 64), device=dev)
    u, s0 = torch.zeros((2, 64), device=dev), torch.zeros((1, 2, 64, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv_scan(r, r.transpose(1, 2).contiguous().transpose(1, 2), r, r, u, s0,
                      impl="cuda")


# --------------------------------------------------------------------------
# the attention backward (csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------

#: relative L2 gates of the backward kernel against autograd through the plain
#: version: float32 holds the float32 route's 1e-5; in bf16 both sides round
#: the same float32 gradients to bf16
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", [
    (2, 4, 4, 130, 130, 64, True, 0), (1, 8, 2, 200, 200, 128, True, 0),
    (1, 4, 2, 150, 150, 320, True, 40), (1, 2, 1, 37, 130, 16, True, 0),
    (2, 4, 4, 90, 33, 64, False, 0), (1, 4, 4, 20, 75, 100, False, 0)])
def test_flash_attention_bwd_kernel(dev, dtype, b, hq, hkv, tq, tk, d, causal, window):
    g = torch.Generator(device=dev).manual_seed(tq * 7 + d)
    q = torch.randn((b, tq, hq, d), generator=g, device=dev).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, hkv, tk, d), generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn((b, hq, tq, d), generator=g, device=dev).to(dtype)
    counter = fa._BWD_F32 if dtype == torch.float32 else fa._BWD
    before = counter.launches
    q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q_, k_, v_, causal=causal, window=window)
    got = torch.autograd.grad(out, (q_, k_, v_), do)
    want = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for x, y, t in zip(got, want, (q, k, v)):
        assert x.dtype == dtype and x.shape == t.shape
        assert _rel(x, y) <= BWD_REL[dtype]
    again = fa.flash_attention_bwd(q, k, v, do, causal, window)
    assert all(torch.equal(x, y) for x, y in zip(got, again))     # no atomics: repeatable


def test_flash_attention_bwd_faults_break_it(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, 8, 130, 64), generator=g, device=dev)
    k, v = (torch.randn((1, 2, 130, 64), generator=g, device=dev) for _ in range(2))
    do = torch.randn_like(q)
    want = fa.flash_attention_bwd_plain(q, k, v, do)
    try:
        for fault in (1, 2, 4, 8):
            fa.bwd_fault = fault
            got = fa.flash_attention_bwd(q, k, v, do)
            assert max(_rel(x, y) for x, y in zip(got, want)) > 100 * BWD_REL[torch.float32]
    finally:
        fa.bwd_fault = 0


def test_kernel_routes_without_a_backward_refuse_a_gradient(dev):
    """mamba_scan and rwkv_scan raise on CUDA tensors that need a gradient,
    naming the ROADMAP item."""
    x = torch.zeros((1, 4, 2, 64), device=dev, requires_grad=True)
    dt = torch.zeros((1, 4, 2), device=dev)
    bc = torch.zeros((1, 4, 16), device=dev)
    with pytest.raises(NotImplementedError, match="item 7c"):
        ops.mamba_scan(x, dt, bc, bc, torch.zeros(2, device=dev),
                       torch.zeros((1, 2, 16, 64), device=dev))
    with pytest.raises(NotImplementedError, match="item 7c"):
        ops.rwkv_scan(x, x, x, x, torch.zeros((2, 64), device=dev),
                      torch.zeros((1, 2, 64, 64), device=dev))


#: probs_bf16's backward against autograd through the plain version with the
#: flag (tests/test_torch_flash_bwd_tiles.py's PB_F32_REL_L2 and PB_BF16_REL_L2:
#: on float32 operands a rounding of P at a bf16 midpoint can go either way)
PB_BWD_REL = {torch.float32: 2e-4, torch.bfloat16: 5e-4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", [
    (2, 4, 2, 130, 130, 64, True, 0), (1, 4, 4, 100, 100, 192, True, 0),
    (1, 4, 2, 150, 150, 128, True, 40)])
def test_flash_attention_probs_bf16_bwd(dev, dtype, b, hq, hkv, tq, tk, d, causal, window):
    """FlashAttentionFn with probs_bf16: one backward launch, the plain
    version's gradients within PB_BWD_REL, and the flag ignored (fault 32)
    past twice that."""
    g = torch.Generator(device=dev).manual_seed(tq + d)
    q = torch.randn((b, hq, tq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, hkv, tk, d), generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn_like(q)
    counter = fa._BWD_F32 if dtype == torch.float32 else fa._BWD
    before = counter.launches
    q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q_, k_, v_, causal=causal, window=window, probs_bf16=True)
    got = torch.autograd.grad(out, (q_, k_, v_), do)
    want = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window,
                                        probs_bf16=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert max(_rel(x, y) for x, y in zip(got, want)) <= PB_BWD_REL[dtype]
    try:
        fa.bwd_fault = 32
        off = fa.flash_attention_bwd(q, k, v, do, causal, window, probs_bf16=True)
    finally:
        fa.bwd_fault = 0
    assert max(_rel(x, y) for x, y in zip(off, want)) > 2 * PB_BWD_REL[dtype]


@pytest.mark.parametrize("knobs", [{}, {"moe_dedup_dispatch": True},
                                   {"moe_payload_dtype": "bfloat16"}],
                         ids=["base", "dedup", "bf16_payload"])
def test_moe_backward_through_the_wire_kernels(dev, knobs):
    """moe_apply's forward and backward at reduced arctic-480b (float32)
    through the wire kernels against the plain versions: y and every
    gradient bit for bit (the wire moves words), the transposes launching
    the wire kernels."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = dataclasses.replace(reduced(get_config("arctic-480b")), **knobs)
    params = moe.moe_init(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32, dev)
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    leaves = [x, params["router"], *params["experts"].values(),
              *params["dense"].values()]
    runs = {}
    for impl in ("auto", "torch"):
        ts = [t.detach().requires_grad_() for t in leaves]
        p = dict(params, router=ts[1], experts=dict(zip(params["experts"], ts[2:5])),
                 dense=dict(zip(params["dense"], ts[5:])))
        before = {n: c for n, c in build.launch_counts().items()}
        y, aux, _ = moe.moe_apply(p, ts[0], cfg, impl=impl)
        fwd = {n: c - before[n] for n, c in build.launch_counts().items()}
        grads = torch.autograd.grad((y ** 2).sum() + aux, ts)
        bwd = {n: c - before[n] - fwd[n] for n, c in build.launch_counts().items()}
        runs[impl] = (y, grads, fwd, bwd)
    (yk, gk, fwd, bwd), (yp, gp, fwdp, bwdp) = runs["auto"], runs["torch"]
    assert torch.equal(yk, yp)
    assert all(torch.equal(a, b) for a, b in zip(gk, gp))
    assert all(bool(g.abs().gt(0).any()) for g in gk[2:5])     # every expert stack learns
    assert fwd["bin_offsets"] == 1 and fwd["pack_rows"] == 1 and fwd["place_rows"] == 6
    assert bwd["pack_rows"] == 1 and bwd["place_rows"] == 1 and bwd["bin_offsets"] == 0
    assert not any(fwdp.values()) and not any(bwdp.values())
