"""The port's MoE dispatch on 4 gloo ranks against the JAX package at P=4.

``tests/torch_moe_multirank_run.py`` runs the same scenarios (reduced
arctic-480b, float32: a sequence-split call, the same with one row per
distinct owner, split-phase with retry rounds under a capacity that
drops, and a decode-shaped call) once under JAX ``shard_map`` over a
(data=1, model=4) mesh of fake CPU devices (``impl="jnp"``) and once on
4 gloo ranks of the port, each holding its experts; each run is a
subprocess with its own timeout.  Every rank's ``y`` must be within 1e-5
relative L2 of JAX's when T splits (gathered over the ranks), ``aux``
within 1e-6, and ``expert_load``, the wire drops and each rank's cost log
equal to JAX's.

At T = 1 only the first rank's ``y`` is compared.  Every rank dispatches
every token there, so each owner's bins get P copies of each token, fill
in arrival order and drop the later ranks' copies: the ranks' outputs
differ, and JAX's ``shard_map`` (``check_vma=False``) reports the first
rank's as if it were replicated.  That is an open fault of the reference
(ROADMAP Queue 3), which the port keeps for parity; it is not pinned as
expected behaviour here.
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

from torch_moe_multirank_run import NPROCS, SCENARIOS  # noqa: E402

RUN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_multirank")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"), JAX_PLATFORMS="cpu")
    script = str(HERE / "torch_moe_multirank_run.py")
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


@pytest.mark.parametrize("name", SCENARIOS)
def test_moe_ranks_match_shard_map(runs, name):
    ref, ranks = runs
    _, _, t = SCENARIOS[name]
    want = ref[f"{name}.y"]
    compared = ranks if t % NPROCS == 0 else ranks[:1]
    for r, got in enumerate(compared):
        assert float(got[f"{name}.margin"]) > 1e-6, (name, r)
        y = got[f"{name}.y"]
        assert y.shape == want.shape, (name, r)
        err = np.linalg.norm(y - want) / np.linalg.norm(want)
        assert err <= 1e-5, f"{name} rank {r}: y relative L2 {err:.3g}"
    for r, got in enumerate(ranks):
        assert abs(float(got[f"{name}.aux"]) - float(ref[f"{name}.aux"])) <= 1e-6, (name, r)
        assert np.array_equal(got[f"{name}.load"], ref[f"{name}.load"]), (name, r)
        assert int(got[f"{name}.dropped"]) == int(ref[f"{name}.dropped"]), (name, r)
        assert json.loads(str(got[f"{name}.costs"])) == json.loads(str(ref[f"{name}.costs"])), \
            (name, r)


def test_moe_multirank_run_exercised_the_exchange(runs):
    """Not vacuous: tokens crossed ranks, the tight capacity dropped on the
    wire after its retry round, and at T = 1 the owners' bins dropped."""
    ref, ranks = runs
    n = {name: b * t * 2 for name, (_, b, t) in SCENARIOS.items()}   # top-2 copies
    assert 0 < ref["seq.load"].sum() <= n["seq"]
    assert int(ref["seq_async_rounds.dropped"]) > 0
    assert "moe.dispatch.retry" in json.loads(str(ref["seq_async_rounds.costs"]))
    assert json.loads(str(ref["seq.costs"]))["moe.dispatch"]["collectives"] == 2
    # each owner saw every rank's copy of each decode token, and its bins
    # dropped some (the open fault at T % P != 0, ROADMAP Queue 3)
    assert ref["decode.load"].sum() < NPROCS * n["decode"]
