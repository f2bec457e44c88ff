"""Four-rank hash-map, Bloom filter, HashMapBuffer, exchange-extension and
LM-data dedup run for tests/test_torch_multirank.py.

    python tests/torch_multirank_run.py jax OUT.npz
        the JAX package under shard_map over 4 fake CPU devices, with the
        jnp paths (a Pallas kernel cannot run inside shard_map on jax 0.9:
        check_vma wants a vma on every ShapeDtypeStruct);
    python tests/torch_multirank_run.py torch OUT_DIR
        the port on 4 gloo ranks spawned with torch.multiprocessing, one
        rank{r}.npz each.

Both run the same op sequences on the same numpy inputs (rank r holds
rows [r*NLOC, (r+1)*NLOC) of every batch) and save every per-rank
result, the table, filter and ring shards, and the cost log as JSON.
The dedup case: each port rank runs a ``repro_torch.data.Deduper`` over
its DEDUP_DOCS documents of every batch (``observe``, ``observe_and_probe``,
``count_of``); JAX's ``Deduper`` reads the host between container calls,
so the reference composes the same container calls with the same
arguments inside the ``shard_map``, on shingles from JAX's
``Deduper.shingles``.  Its cost log is kept apart (``dedup_costs``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

NPROCS, NLOC, CAP, BLOCK = 4, 64, 4096, 16
RANKS_TIMEOUT_S = 100
#: the dedup case: documents per rank and batch, tokens per document, and
#: the DedupSpec (two retry rounds, so the wire rounds cross ranks too)
DEDUP_DOCS, DEDUP_LEN = 2, 24
DEDUP_SPEC = dict(ngram=4, nbits=1 << 12, table_capacity=1 << 10, max_rounds=2)
DEDUP_BATCHES = ("dd_a", "dd_c", "dd_probe")


def inputs() -> dict:
    rng = np.random.default_rng(0)
    n = NPROCS * NLOC
    pool = (rng.permutation(1 << 20)[:3 * n].astype(np.uint32) * np.uint32(2654435761))
    keys = pool[:n]
    absent = pool[2 * n:3 * n]
    q = np.concatenate([keys[: n // 2], absent[: n // 2]])
    rng.shuffle(q)
    return {
        "keys": keys, "vals": keys * np.uint32(7) + np.uint32(1),
        "q": q, "fk": np.concatenate([keys[n // 2:], absent[n // 2:]]),
        "ik": pool[n:2 * n], "iv": pool[n:2 * n] ^ np.uint32(0xABCDEF),
        "pay": rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32),
        "rdest": rng.integers(0, NPROCS, n).astype(np.int32),
        # 2-lane items with duplicates across and within ranks
        "items": np.concatenate([pool[:n // 2], pool[:n // 2]])[rng.permutation(n)]
                 .reshape(-1, 1).repeat(2, axis=1) ^ np.uint32(0x5A5A5A5A) * np.arange(
                     2, dtype=np.uint32),
        "ivals": pool[:n] >> np.uint32(3),
        "probes": np.stack([pool[n // 2:3 * n // 2], pool[n // 2:3 * n // 2]], axis=1)
                  ^ np.uint32(0x5A5A5A5A) * np.arange(2, dtype=np.uint32),
    }


def dedup_inputs() -> dict:
    """Documents of three batches, rank r holding rows [r*DEDUP_DOCS,
    (r+1)*DEDUP_DOCS): copies within a rank and across ranks, and a probe
    of half observed, half fresh documents."""
    rng = np.random.default_rng(1)
    n, t = NPROCS * DEDUP_DOCS, DEDUP_LEN
    a = rng.integers(0, 500, (n, t)).astype(np.int32)
    a[1] = a[0]                                   # within rank 0's batch
    a[3::2] = a[0:-2:2]                           # rank r holds rank r-1's first doc
    c = rng.integers(1000, 1500, (n, t)).astype(np.int32)
    c[::2] = a[np.arange(3, n + 3, 2) % n]        # documents another rank observed
    probe = rng.integers(3000, 3500, (n, t)).astype(np.int32)
    probe[::2] = a[np.arange(5, n + 5, 2) % n]
    return {"dd_a": a, "dd_c": c, "dd_probe": probe}


def dedup_reference(bl, hm, bk, kspec, vspec, d, u32_ones, kw) -> dict:
    """The container calls of ``observe``, ``observe_and_probe`` and
    ``count_of`` on one rank's shingles (``d[name + "_hi"|"_lo"]``), as
    the JAX Deduper makes them (``kw``: impl)."""
    r = DEDUP_SPEC["max_rounds"]

    def cap(m):
        return max(1, -(-m // r))

    def flat(name):
        return {"hi": d[name + "_hi"], "lo": d[name + "_lo"]}

    bspec, bst = bl.bloom_create(bk, DEDUP_SPEC["nbits"], kspec, k=4, **kw)
    hspec, hst = hm.hashmap_create(bk, DEDUP_SPEC["table_capacity"], kspec, vspec,
                                   block_size=64, **kw)
    out = {}
    a, c, p = flat("dd_a"), flat("dd_c"), flat("dd_probe")
    m = a["hi"].shape[0]
    bst, seen1 = bl.insert(bk, bspec, bst, a, capacity=cap(m), max_rounds=r)
    hst, _ = hm.insert(bk, hspec, hst, a, u32_ones(m), capacity=cap(m), valid=seen1,
                       mode=1, attempts=3, max_rounds=r)
    bst, seen2, probed = bl.insert_find(bk, bspec, bst, c, p, capacity_ins=cap(m),
                                        capacity_find=cap(m), max_rounds=r)
    hst, _ = hm.insert(bk, hspec, hst, c, u32_ones(m), capacity=cap(m), valid=seen2,
                       mode=1, attempts=3, max_rounds=r)
    hst, v, found = hm.find(bk, hspec, hst, a, capacity=cap(m), max_rounds=r)
    out.update(d_seen1=seen1, d_seen2=seen2, d_probed=probed, d_v=v, d_found=found,
               d_words=bst.words, d_tkeys=hst.tkeys, d_tvals=hst.tvals,
               d_status=hst.status)
    return out


def scenario(hm, ex, bk, spec, st, d) -> dict:
    """The op sequence, written once against either package."""
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=NLOC)
    st, v, f = hm.find(bk, spec, st, d["q"], capacity=NLOC)
    st, v2, f2 = hm.find(bk, spec, st, d["q"], capacity=NLOC, speculative=False)
    st, fv, ff, fok = hm.find_insert(bk, spec, st, d["fk"], d["ik"], d["iv"],
                                     capacity=NLOC)
    # small capacity: retry rounds ship part of the overflow, the rest drops
    st, okd = hm.insert(bk, spec, st, d["iv"], d["ik"], capacity=NLOC // 16,
                        max_rounds=2)
    r = ex.route(bk, d["pay"], d["rdest"], NLOC // 8)
    return {"tkeys": st.tkeys, "tvals": st.tvals, "status": st.status,
            "ok": ok, "vals": v, "found": f, "vals2": v2, "found2": f2,
            "fvals": fv, "ffound": ff, "fok": fok, "okd": okd,
            "count": hm.count_ready(bk, st).reshape(1),
            "r_payload": r.payload, "r_valid": r.valid, "r_src_pos": r.src_pos,
            "r_dropped": r.dropped.reshape(1), "r_send_item": r.send_item,
            "r_send_occ": r.send_occ}


def scenario_bloom_buffer(bl, hm, hb, bk, kspec, vspec, d, kw) -> dict:
    """Bloom pre-pass and a HashMapBuffer flush, written once for either
    package (``kw``: impl and device)."""
    bspec, bst = bl.bloom_create(bk, 1 << 12, kspec, k=4, **kw)
    bst, seen = bl.insert(bk, bspec, bst, d["items"], capacity=NLOC)
    present = bl.find(bk, bspec, bst, d["probes"], capacity=NLOC)
    mspec, mst = hm.hashmap_create(bk, CAP, kspec, vspec, block_size=BLOCK, **kw)
    hspec, hst = hb.create(bk, mspec, mst, queue_capacity=2 * NLOC, buffer_cap=NLOC)
    hst, over = hb.insert(hspec, hst, d["items"], d["ivals"])
    hst, dropped = hb.flush(bk, hspec, hst, capacity=NLOC // 4)     # the wire drops
    hst, _ = hb.insert(hspec, hst, d["items"][: NLOC // 2], d["ivals"][: NLOC // 2])
    hst, dropped2 = hb.flush(bk, hspec, hst, capacity=NLOC, mode=1)
    return {"b_words": bst.words, "b_seen": seen, "b_present": present,
            "h_tkeys": hst.map.tkeys, "h_tvals": hst.map.tvals,
            "h_status": hst.map.status, "h_qdata": hst.queue.data,
            "h_head": hst.queue.head, "h_tail": hst.queue.tail,
            "h_over": over.reshape(1), "h_dropped": dropped.reshape(1),
            "h_dropped2": dropped2.reshape(1)}


def scenario_ext(hm, core, bk, table, d) -> dict:
    """The exchange extensions: a 2 x 2 hierarchical insert and find, a
    corrupt + kill fault spec under integrity and its heal, a degraded
    insert with rank 3 dead, and a split-phase find_insert, written once
    for either package (``core`` its core module, ``table()`` a fresh map)."""
    spec, st = table()
    hier = core.HierarchicalTransport(2, 2)
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=NLOC, transport=hier)
    st, v, f = hm.find(bk, spec, st, d["q"], capacity=NLOC, transport=hier)
    spec2, st2 = table()
    faulty = core.FaultInjectingTransport(core.make_transport("dense"), core.FaultSpec(
        seed=11, corrupt=((0, 1, 2),), kill_ranks=(3,), kill_from_launch=1))
    st2, ok1 = hm.insert(bk, spec2, st2, d["keys"], d["vals"], capacity=NLOC // 4,
                         max_rounds=4, attempts=1, transport=faulty, integrity=True)
    st2, ok2 = hm.insert(bk, spec2, st2, d["keys"], d["vals"], capacity=NLOC // 4,
                         max_rounds=4, valid=~ok1, attempts=1, integrity=True)
    st3, ok3 = hm.insert(bk, spec2, st2, d["ik"], d["iv"], capacity=NLOC, attempts=1,
                         dead_ranks=(3,))
    st4, fv, ff, fok = hm.find_insert(bk, spec, st, d["fk"], d["ik"], d["iv"],
                                      capacity=NLOC, transport=hier, async_=True).finish()
    return {"x_tkeys": st.tkeys, "x_status": st.status, "x_ok": ok, "x_vals": v,
            "x_found": f, "x_ok1": ok1, "x_ok2": ok2, "x_tkeys2": st2.tkeys,
            "x_tvals2": st2.tvals, "x_ok3": ok3, "x_status3": st3.status,
            "x_tkeys4": st4.tkeys, "x_fvals": fv, "x_ffound": ff, "x_fok": fok}


def cost_summary(log) -> dict:
    return {name: log.by_op(name).__dict__ for name in sorted({n for n, _ in log.entries})}


def run_jax(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={NPROCS}"
    import jax
    import jax.numpy as jnp
    from jax import ShapeDtypeStruct as SDS
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.containers import bloom as bl
    from repro.containers import hashmap as hm
    from repro.containers import hashmap_buffer as hb
    import repro.core as core
    from repro.core import costs, exchange as ex
    from repro.core.backend import get_backend
    from repro.data.dedup import Deduper, DedupSpec

    mesh = make_mesh((NPROCS,), ("bcl",))
    d = {k: jnp.asarray(v) for k, v in inputs().items()}
    shingler = Deduper(get_backend(None), DedupSpec(**DEDUP_SPEC))
    for name, docs in dedup_inputs().items():
        for lane, words in shingler.shingles(docs).items():
            d[f"{name}_{lane}"] = words.reshape(-1)      # rank-major, as the docs
    names = sorted(d)
    dedup_log = []

    def body(*arrays):
        bk = get_backend("bcl")
        spec, st = hm.hashmap_create(bk, CAP, SDS((), jnp.uint32), SDS((), jnp.uint32),
                                     block_size=BLOCK, impl="jnp")
        dd = dict(zip(names, arrays))
        out = scenario(hm, ex, bk, spec, st, dd)
        out.update(scenario_bloom_buffer(bl, hm, hb, bk, SDS((2,), jnp.uint32),
                                         SDS((), jnp.uint32), dd, {"impl": "jnp"}))
        out.update(scenario_ext(hm, core, bk, lambda: hm.hashmap_create(
            bk, CAP, SDS((), jnp.uint32), SDS((), jnp.uint32), block_size=BLOCK,
            impl="jnp"), dd))
        with costs.recording() as dlog:
            out.update(dedup_reference(
                bl, hm, bk, {"hi": SDS((), jnp.uint32), "lo": SDS((), jnp.uint32)},
                SDS((), jnp.uint32), dd, lambda m: jnp.ones((m,), jnp.uint32),
                {"impl": "jnp"}))
        dedup_log.append(dlog)
        return tuple(out[k] for k in sorted(out)), sorted(out)

    keys_out = []

    def body_arrays(*arrays):
        outs, ks = body(*arrays)
        keys_out[:] = ks
        return outs

    with costs.recording() as log:
        f = jax.jit(shard_map(body_arrays, mesh=mesh, in_specs=(P("bcl"),) * len(names),
                              out_specs=P("bcl")))
        outs = f(*(d[k] for k in names))
    res = {k: np.asarray(v) for k, v in zip(keys_out, outs)}
    res["costs"] = np.asarray(json.dumps(cost_summary(log)))
    res["dedup_costs"] = np.asarray(json.dumps(cost_summary(dedup_log[0])))
    np.savez(out_path, **res)


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    from repro_torch.containers import bloom as bl
    from repro_torch.containers import hashmap as hm
    from repro_torch.containers import hashmap_buffer as hb
    import repro_torch.core as core
    from repro_torch.core import costs, exchange as ex
    from repro_torch.core.backend import ProcessGroupBackend
    from repro_torch.core.object_container import Spec
    from repro_torch.data import Deduper, DedupSpec

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=NPROCS, rank=rank)
    try:
        bk = ProcessGroupBackend()
        sl = slice(rank * NLOC, (rank + 1) * NLOC)
        d = {k: torch.from_numpy(np.array(v[sl])) for k, v in inputs().items()}
        spec, st = hm.hashmap_create(bk, CAP, Spec((), torch.uint32), Spec((), torch.uint32),
                                     block_size=BLOCK, impl="torch", device="cpu")
        with costs.recording() as log:
            out = scenario(hm, ex, bk, spec, st, d)
            out.update(scenario_bloom_buffer(bl, hm, hb, bk, Spec((2,), torch.uint32),
                                             Spec((), torch.uint32), d,
                                             {"impl": "torch", "device": "cpu"}))
            out.update(scenario_ext(hm, core, bk, lambda: hm.hashmap_create(
                bk, CAP, Spec((), torch.uint32), Spec((), torch.uint32), block_size=BLOCK,
                impl="torch", device="cpu"), d))
        dsl = slice(rank * DEDUP_DOCS, (rank + 1) * DEDUP_DOCS)
        docs = {k: v[dsl] for k, v in dedup_inputs().items()}
        dd = Deduper(bk, DedupSpec(**DEDUP_SPEC), device="cpu", impl="torch")
        with costs.recording() as dlog:
            out["d_frac1"], out["d_dup1"] = dd.observe(docs["dd_a"])
            out["d_frac2"], out["d_dup2"], out["d_probe_frac"] = dd.observe_and_probe(
                docs["dd_c"], docs["dd_probe"])
            out["d_counts"] = dd.count_of(docs["dd_a"])
        out.update(d_words=dd.bstate.words, d_tkeys=dd.hstate.tkeys,
                   d_tvals=dd.hstate.tvals, d_status=dd.hstate.status)
        res = {k: v.numpy() for k, v in out.items()}
        res["costs"] = np.asarray(json.dumps(cost_summary(log)))
        res["dedup_costs"] = np.asarray(json.dumps(cost_summary(dlog)))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_torch(out_dir: str) -> None:
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_rank, args=(port, out_dir), nprocs=NPROCS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after {RANKS_TIMEOUT_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


if __name__ == "__main__":
    mode, target = sys.argv[1], sys.argv[2]
    run_jax(target) if mode == "jax" else run_torch(target)
