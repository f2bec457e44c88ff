"""Four-rank hash-map run for tests/test_torch_multirank.py.

    python tests/torch_multirank_run.py jax OUT.npz
        the JAX package under shard_map over 4 fake CPU devices, with the
        jnp paths (a Pallas kernel cannot run inside shard_map on jax 0.9:
        check_vma wants a vma on every ShapeDtypeStruct);
    python tests/torch_multirank_run.py torch OUT_DIR
        the port on 4 gloo ranks spawned with torch.multiprocessing, one
        rank{r}.npz each.

Both run the same op sequence on the same numpy inputs (rank r holds
rows [r*NLOC, (r+1)*NLOC) of every batch) and save every per-rank
result, the table shards, and the cost log as JSON.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

NPROCS, NLOC, CAP, BLOCK = 4, 64, 4096, 16
RANKS_TIMEOUT_S = 100


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
    }


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


def cost_summary(log) -> dict:
    return {name: log.by_op(name).__dict__ for name in sorted({n for n, _ in log.entries})}


def run_jax(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={NPROCS}"
    import jax
    import jax.numpy as jnp
    from jax import ShapeDtypeStruct as SDS
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.containers import hashmap as hm
    from repro.core import costs, exchange as ex
    from repro.core.backend import get_backend

    mesh = make_mesh((NPROCS,), ("bcl",))
    d = {k: jnp.asarray(v) for k, v in inputs().items()}
    names = sorted(d)

    def body(*arrays):
        bk = get_backend("bcl")
        spec, st = hm.hashmap_create(bk, CAP, SDS((), jnp.uint32), SDS((), jnp.uint32),
                                     block_size=BLOCK, impl="jnp")
        out = scenario(hm, ex, bk, spec, st, dict(zip(names, arrays)))
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
    np.savez(out_path, **res)


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    from repro_torch.containers import hashmap as hm
    from repro_torch.core import costs, exchange as ex
    from repro_torch.core.backend import ProcessGroupBackend
    from repro_torch.core.object_container import Spec

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
        res = {k: v.numpy() for k, v in out.items()}
        res["costs"] = np.asarray(json.dumps(cost_summary(log)))
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
