"""The genomics slice as a whole: the port against the JAX package.

``GenomeSim`` reads and the k-mer helpers must equal
``repro.data.genomics``; then the paper's assembly pipeline (section
9.2) runs on a 2**10-base genome in both packages from the same numpy
inputs over a ``SerialBackend``: the Bloom pre-pass, k-mer counting,
the buffered de Bruijn build (HashMapBuffer insert + flush), a local
find of every extension and of absent keys, and a walk.  JAX runs with
``impl="jnp"`` under one ``jax.jit``, the port its plain versions on
the CPU.  Every output
is integer, so the tolerance is 0: seen flags, found flags, all three
tables, drops, values and walk counts bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ShapeDtypeStruct as SDS

from repro.containers import bloom as jbl
from repro.containers import hashmap as jhm
from repro.containers import hashmap_buffer as jhb
from repro.core.backend import SerialBackend as JSerial
from repro.core.promises import ConProm as JConProm
from repro.data import genomics as jgen
from repro_torch.containers import bloom as tbl
from repro_torch.containers import hashmap as thm
from repro_torch.containers import hashmap_buffer as thb
from repro_torch.core.backend import SerialBackend as TSerial
from repro_torch.core.object_container import Spec
from repro_torch.core.promises import ConProm as TConProm
from repro_torch.data import genomics as tgen
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

K = 21
MODE_ADD = 1


@pytest.mark.parametrize("glen,seed", [(1 << 10, 0), (3000, 7)])
def test_genome_sim_matches_jax(glen, seed):
    j = jgen.GenomeSim(genome_len=glen, coverage=8, error_rate=0.01, seed=seed)
    t = tgen.GenomeSim(genome_len=glen, coverage=8, error_rate=0.01, seed=seed)
    assert np.array_equal(j.genome(), t.genome())
    assert np.array_equal(j.reads(), t.reads())


@pytest.mark.parametrize("k", [5, 17, 21, 31])
def test_kmer_helpers_match_jax(k):
    reads = jgen.GenomeSim(genome_len=1 << 11, seed=k).reads()
    want = jgen.pack_kmers(jgen.extract_kmers(reads, k))
    r = torch.from_numpy(reads)
    assert np.array_equal(tgen.pack_kmers(tgen.extract_kmers(reads, k)), want)
    for got in (tgen.read_kmer_lanes(r, k), tgen.pack_kmers(tgen.extract_kmers(r, k))):
        assert np.array_equal(got.numpy().view(np.uint32), want)
    lanes = torch.from_numpy(want.view(np.int32))
    assert np.array_equal(tgen.unpack_kmers(want, k), jgen.unpack_kmers(want, k))
    assert np.array_equal(tgen.kmer_lanes(tgen.kmer_values(lanes)), lanes)
    for b, (jn, tn) in enumerate(zip(jgen.kmer_neighbors(want, k),
                                     tgen.kmer_neighbors(lanes, k))):
        assert np.array_equal(tn.numpy().view(np.uint32), jn)
        base = torch.full((want.shape[0],), b, dtype=torch.int32)
        assert np.array_equal(tgen.kmer_step(lanes, base, k).numpy().view(np.uint32), jn)


def _inputs(glen=1 << 10, seed=3, walks=32):
    """k-mers, probes, solid extensions and walk starts, in numpy."""
    reads = jgen.GenomeSim(genome_len=glen, coverage=8, error_rate=0.01,
                           seed=seed).reads()
    kmers = jgen.pack_kmers(jgen.extract_kmers(reads, K))
    rng = np.random.default_rng(seed)
    ext = jgen.extract_kmers(reads, K + 1)
    e_uniq, e_cnt = np.unique(ext, axis=0, return_counts=True)
    solid = e_uniq[e_cnt >= 2]
    key = jgen.pack_kmers(solid[:, :K])
    absent = np.stack([rng.integers(1 << 10, 1 << 30, 200), rng.integers(0, 1 << 32, 200)],
                      axis=1).astype(np.uint32)
    return {
        "kmers": kmers, "ones": np.ones(kmers.shape[0], np.uint32),
        "probes": np.concatenate([kmers[rng.integers(0, kmers.shape[0], 200)], absent]),
        "ext_key": key, "ext_next": solid[:, K].astype(np.uint32),
        "lookup": np.concatenate([key, absent]),
        "starts": key[rng.integers(0, key.shape[0], walks)],
    }


def _jax_step(cur, base):
    hi = ((cur[:, 0] << 2) | (cur[:, 1] >> 30)) & jnp.uint32((1 << (2 * K - 32)) - 1)
    return jnp.stack([hi, (cur[:, 1] << 2) | (base & jnp.uint32(3))], axis=1)


def _torch_step(cur, base):
    return tgen.kmer_step(cur.view(torch.int32), base.view(torch.int32), K)


def _torch_where(mask, a, b):
    return torch.where(mask, a.view(torch.int32), b.view(torch.int32))


def pipeline(bl, hm, hb, P, bk, kspec, vspec, step, where, d, kw, steps=8):
    """Paper Figs. 6-8 on either package (``kw``: impl and device)."""
    n, n_ext = d["kmers"].shape[0], d["ext_key"].shape[0]
    bspec, bst = bl.bloom_create(bk, 1 << 14, kspec, k=4, **kw)
    bst, seen = bl.insert(bk, bspec, bst, d["kmers"], capacity=n)
    present = bl.find(bk, bspec, bst, d["probes"], capacity=d["probes"].shape[0])

    cspec, cst = hm.hashmap_create(bk, 1 << 13, kspec, vspec, block_size=64, **kw)
    cst, cok = hm.insert(bk, cspec, cst, d["kmers"], d["ones"], capacity=n,
                         mode=MODE_ADD, attempts=2, valid=seen)

    mspec, mst = hm.hashmap_create(bk, 1 << 13, kspec, vspec, block_size=64, **kw)
    hspec, hst = hb.create(bk, mspec, mst, queue_capacity=2 * n_ext,
                           buffer_cap=2 * n_ext)
    hst, over = hb.insert(hspec, hst, d["ext_key"], d["ext_next"])
    hst, dropped = hb.flush(bk, hspec, hst, capacity=2 * n_ext)
    _, lvals, lfound = hm.find(bk, mspec, hst.map, d["lookup"], capacity=1,
                               promise=P.HashMap.local)

    cur, walked = d["starts"], []
    for _ in range(steps):
        _, v, f = hm.find(bk, mspec, hst.map, cur, capacity=cur.shape[0],
                          promise=P.HashMap.find, attempts=2)
        cur = where(f[:, None], step(cur, v), cur)
        walked.append(f.sum())
    return {"bloom": bst.words, "seen": seen, "present": present, "count": cst,
            "cok": cok, "table": hst.map, "queue": hst.queue, "over": over,
            "dropped": dropped, "lvals": lvals, "lfound": lfound, "cur": cur,
            "walked": walked}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pipeline_matches_jax():
    d = _inputs()
    jout = jax.jit(lambda dd: pipeline(
        jbl, jhm, jhb, JConProm, JSerial(), SDS((2,), jnp.uint32), SDS((), jnp.uint32),
        _jax_step, jnp.where, dd, {"impl": "jnp"}))({k: jnp.asarray(v) for k, v in d.items()})
    tout = pipeline(tbl, thm, thb, TConProm, TSerial(), Spec((2,), torch.uint32),
                    Spec((), torch.uint32), _torch_step, _torch_where,
                    {k: torch.from_numpy(v.copy()) for k, v in d.items()},
                    {"impl": "torch", "device": "cpu"})

    def leaves(out):
        for name, v in sorted(out.items()):
            if isinstance(v, tuple):
                yield from ((f"{name}.{f}", x) for f, x in zip(v._fields, v))
            elif isinstance(v, list):
                yield from ((f"{name}[{i}]", x) for i, x in enumerate(v))
            else:
                yield name, v

    jl, tl = dict(leaves(jout)), dict(leaves(tout))
    assert sorted(jl) == sorted(tl)
    for name in jl:
        j, t = _np(jl[name]), _np(tl[name])
        if t.dtype != j.dtype and t.dtype.itemsize == j.dtype.itemsize:
            t = t.view(j.dtype)
        assert j.shape == t.shape and np.array_equal(j, t), name

    # the run is not vacuous: duplicates seen, extensions found, walks advanced
    seen = _np(tout["seen"])
    assert 0 < seen.sum() < seen.size
    n_ext = d["ext_key"].shape[0]
    assert _np(tout["lfound"])[:n_ext].all() and not _np(tout["lfound"])[n_ext:].any()
    assert int(tout["dropped"]) == 0 and sum(int(w) for w in tout["walked"]) > 0
