"""The port's hash map on 4 gloo ranks against the JAX package at P=4.

``tests/torch_multirank_run.py`` runs the same op sequence (insert with
two attempts, speculative and sequential find, find_insert, a
small-capacity insert with retry rounds and drops, count_ready, and a
dropping ``route``) once under JAX ``shard_map`` over 4 fake CPU
devices (``impl="jnp"``) and once on 4 gloo ranks of the port; each run
is a subprocess with its own timeout.  Every rank's table shard and
results must be bit-identical to the JAX rank's, and each rank's cost
log equal to the JAX trace-time log.
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

from torch_multirank_run import NLOC, NPROCS  # noqa: E402

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


@pytest.mark.parametrize("field", TABLE + RESULTS + ROUTE)
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
