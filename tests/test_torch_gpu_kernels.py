"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test needs a CUDA device and skips without one (the
check runs inside the fixture, so every worker collects the same tests).
Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Every output is integer, so the tolerance is 0: bit equality.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import binning, hash_probe, ref

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
                                     (70000, 2)])
def test_bin_offsets_kernel(dev, n, nbins):
    rng = np.random.default_rng(n + nbins)
    bins = _i32(rng, (n,), 0, nbins).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    _eq(binning.bin_offsets(bins, nbins, valid),
        binning.bin_offsets_plain(bins, nbins, valid))


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
