"""The port's hash map, Bloom filter, HashMapBuffer, exchange extensions
and LM-data dedup on 4 gloo ranks against the JAX package at P=4.

``tests/torch_multirank_run.py`` runs the same op sequence (insert with
two attempts, speculative and sequential find, find_insert, a
small-capacity insert with retry rounds and drops, count_ready, a
dropping ``route``, a Bloom insert + find and two HashMapBuffer
flushes, one of them dropping on the wire; a 2 x 2 hierarchical insert and
find, a corrupt + kill fault spec under integrity and its heal, a
degraded insert with rank 3 dead, a split-phase find_insert; a
``Deduper``'s ``observe``, ``observe_and_probe`` and ``count_of`` over
each rank's documents, against the same container calls composed in the
``shard_map``) once under
JAX ``shard_map`` over 4 fake CPU
devices (``impl="jnp"``) and once on 4 gloo ranks of the port; each run
is a subprocess with its own timeout.  Every rank's table shard and
results must be bit-identical to the JAX rank's, and each rank's cost
log equal to the JAX trace-time log.  Dedup's fractions are computed
from the reference's gathered ``seen`` flags as ``Deduper._count_seen``
does (float64 means of each document's row), its counts as ``count_of``
does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from torch_multirank_run import DEDUP_DOCS, NLOC, NPROCS  # noqa: E402

RUN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"), JAX_PLATFORMS="cpu")
    script = str(HERE / "torch_multirank_run.py")
    procs = {
        "jax": subprocess.Popen([sys.executable, script, "jax", str(tmp / "jax.npz")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True),
        "torch": subprocess.Popen([sys.executable, script, "torch", str(tmp)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True),
    }
    logs = {}
    try:
        for name, p in procs.items():
            logs[name], _ = p.communicate(timeout=RUN_TIMEOUT_S)
            assert p.returncode == 0, f"{name} run failed:\n{logs[name][-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    ref = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)]
    return ref, ranks


def _shard(ref_arr, rank):
    n = ref_arr.shape[0] // NPROCS
    return ref_arr[rank * n:(rank + 1) * n]


TABLE = ["tkeys", "tvals", "status"]
RESULTS = ["ok", "vals", "found", "vals2", "found2", "fvals", "ffound", "fok", "okd",
           "count"]
ROUTE = ["r_payload", "r_valid", "r_src_pos", "r_dropped", "r_send_item", "r_send_occ"]
BLOOM_BUFFER = ["b_words", "b_seen", "b_present", "h_tkeys", "h_tvals", "h_status",
                "h_qdata", "h_head", "h_tail", "h_over", "h_dropped", "h_dropped2"]
EXTENSIONS = ["x_tkeys", "x_status", "x_ok", "x_vals", "x_found", "x_ok1", "x_ok2",
              "x_tkeys2", "x_tvals2", "x_ok3", "x_status3", "x_tkeys4", "x_fvals",
              "x_ffound", "x_fok"]


@pytest.mark.parametrize("field", TABLE + RESULTS + ROUTE + BLOOM_BUFFER + EXTENSIONS)
def test_ranks_bit_identical_to_shard_map(runs, field):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        want = _shard(ref[field], r)
        have = got[field]
        if have.dtype != want.dtype and have.dtype.itemsize == want.dtype.itemsize:
            have = have.view(want.dtype)
        assert want.shape == have.shape, (field, r, want.shape, have.shape)
        assert np.array_equal(want, have), f"rank {r}: {field}"


def test_cost_logs_equal_trace_time_log(runs):
    ref, ranks = runs
    want = json.loads(str(ref["costs"]))
    for r, got in enumerate(ranks):
        assert json.loads(str(got["costs"])) == want, f"rank {r}"


def test_multirank_run_exercised_the_exchange(runs):
    """The run is not vacuous: inserts landed, finds hit and missed across
    ranks, and the small-capacity exchanges dropped."""
    ref, ranks = runs
    assert ref["ok"].all() and ref["fok"].all()
    assert 0 < ref["found"].sum() < ref["found"].size
    assert (~ref["okd"]).any() and ref["okd"].any()
    assert ref["r_dropped"][0] > 0
    assert ref["found"].size == NPROCS * NLOC
    assert ref["b_seen"].any() and not ref["b_seen"].all()
    assert ref["h_dropped"][0] > 0 and (ref["h_status"] & 3 == 2).any()
    # extensions: the faults cost acks, the heal restores every one, the
    # dead rank's keys never land, and the hier ops did real work
    assert ref["x_ok"].all() and 0 < ref["x_found"].sum() < ref["x_found"].size
    assert (~ref["x_ok1"]).any() and (ref["x_ok1"] | ref["x_ok2"]).all()
    assert (~ref["x_ok3"]).any() and ref["x_ok3"].any() and ref["x_fok"].all()


def _dedup_reference(ref) -> dict:
    """The reference's dedup verdicts, as the Deduper derives them from
    its container calls' results (rows of every rank's documents)."""
    docs = NPROCS * DEDUP_DOCS

    def frac(flags):
        return flags.reshape(docs, -1).mean(axis=1)
    out = {"d_frac1": frac(ref["d_seen1"]), "d_frac2": frac(ref["d_seen2"]),
           "d_probe_frac": frac(ref["d_probed"]),
           "d_counts": np.where(ref["d_found"], ref["d_v"].astype(np.int64) + 1, 1)
           .reshape(docs, -1)}
    out["d_dup1"], out["d_dup2"] = out["d_frac1"] > 0.5, out["d_frac2"] > 0.5
    out.update({k: ref[k] for k in ("d_words", "d_tkeys", "d_tvals", "d_status")})
    return out


DEDUP = ["d_frac1", "d_dup1", "d_frac2", "d_dup2", "d_probe_frac", "d_counts", "d_words",
         "d_tkeys", "d_tvals", "d_status"]


@pytest.mark.parametrize("field", DEDUP)
def test_dedup_ranks_equal_composed_reference(runs, field):
    """Each rank's Deduper verdicts, filter shard and table shard."""
    ref, ranks = runs
    want_all = _dedup_reference(ref)[field]
    for r, got in enumerate(ranks):
        want, have = _shard(want_all, r), got[field]
        if have.dtype != want.dtype and have.dtype.itemsize == want.dtype.itemsize \
                and have.dtype.kind in "iu":
            have = have.view(want.dtype)
        assert want.dtype == have.dtype and want.shape == have.shape, (field, r)
        assert np.array_equal(want, have), f"rank {r}: {field}"


def test_dedup_cost_logs_equal_trace_time_log(runs):
    ref, ranks = runs
    want = json.loads(str(ref["dedup_costs"]))
    assert "bloom.insert_find.retry" in want and "hashmap.insert.retry" in want
    for r, got in enumerate(ranks):
        assert json.loads(str(got["dedup_costs"])) == want, f"rank {r}"


def test_dedup_run_is_not_vacuous(runs):
    """Copies across ranks and within a batch are flagged, fresh documents
    are not, the probe sees the observed half only, and counts reach 2."""
    ref, _ = runs
    want = _dedup_reference(ref)
    assert want["d_dup1"].any() and not want["d_dup1"].all()
    assert want["d_dup2"][::2].all() and not want["d_dup2"][1::2].any()
    assert (want["d_probe_frac"][::2] == 1).all() and (want["d_probe_frac"][1::2] < 0.1).all()
    assert (want["d_counts"] >= 2).any()
