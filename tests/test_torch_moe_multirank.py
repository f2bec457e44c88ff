"""The port's MoE dispatch and multi-rank LM on 4 gloo ranks against the JAX package.

``tests/torch_moe_multirank_run.py`` runs the same scenarios once under JAX
``shard_map`` over meshes of 4 fake CPU devices (``impl="jnp"``) and once
on 4 gloo ranks of the port, each holding its slice of the parameters;
each run is a subprocess with its own timeout.

MoE dispatch (reduced arctic-480b, float32: a sequence-split call, the
same with one row per distinct owner, split-phase with retry rounds under
a capacity that drops, and a decode-shaped call): every rank's ``y`` must
be within 1e-5 relative L2 of JAX's, ``aux`` within 1e-6, and
``expert_load``, the wire drops and each rank's cost log equal to JAX's.
At T = 1 (B = 4) each rank dispatches one row of the flattened tokens and
every rank returns the gathered output; JAX's side runs the same call as
``x.reshape(1, B*T, D)``.  (JAX's ``moe_apply`` on the (B, 1, D) call
itself has every rank dispatch every token and returns the first rank's
output: the fault ROADMAP Queue 3 records as closed by this split.)

The multi-rank LM (reduced qwen3-4b, also with 2 kv heads over 4 ranks;
arctic-480b at (1, 4) and (2, 2); deepseek-v3 with the context-parallel
MLA decode; internvl2-76b with its patch embeddings before the prompt): every rank's logits within 1e-5 relative L2 of JAX's mesh
run at the prefill and at each of 3 decode steps, and ``serve`` at the
layout gives every rank the one-rank run's tokens.
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

from torch_moe_multirank_run import LM_BATCH, LM_SCENARIOS, LM_STEPS, NPROCS, SCENARIOS  # noqa: E402

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
    want = ref[f"{name}.y"]
    for r, got in enumerate(ranks):
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
    wire after its retry round, and at T = 1 each copy was dispatched
    once, by one rank (some dropped at the default slack)."""
    ref, ranks = runs
    n = {name: b * t * 2 for name, (_, b, t) in SCENARIOS.items()}   # top-2 copies
    assert 0 < ref["seq.load"].sum() <= n["seq"]
    assert int(ref["seq_async_rounds.dropped"]) > 0
    assert "moe.dispatch.retry" in json.loads(str(ref["seq_async_rounds.costs"]))
    assert json.loads(str(ref["seq.costs"]))["moe.dispatch"]["collectives"] == 2
    # one copy of each (token, expert) pair reached the wire: served or dropped,
    # never the P copies every rank's dispatch of every token made
    load, dropped = ref["decode.load"].sum(), int(ref["decode.dropped"])
    assert 0 < load and load + dropped <= n["decode"]


@pytest.mark.parametrize("name", LM_SCENARIOS)
def test_lm_ranks_match_jax_mesh(runs, name):
    """Each rank's logits (its data rank's rows) at the prefill and at every
    decode step within 1e-5 relative L2 of JAX's run under the same mesh;
    the router's top-k margins clear of float32 noise."""
    ref, ranks = runs
    vocab = 256                        # every reduced config's
    data, model = LM_SCENARIOS[name][2]
    nb = LM_BATCH // data
    for r, got in enumerate(ranks):
        assert float(got[f"{name}.margin"]) > 1e-6, (name, r)
        rows = slice(r // model * nb, (r // model + 1) * nb)
        for s in range(LM_STEPS + 1):
            want = ref[f"{name}.logits{s}"][rows, :vocab]
            lg = got[f"{name}.logits{s}"][:, :vocab]
            err = np.linalg.norm(lg - want) / np.linalg.norm(want)
            assert err <= 1e-5, f"{name} rank {r} step {s}: logits relative L2 {err:.3g}"


@pytest.mark.parametrize("name", LM_SCENARIOS)
def test_lm_serve_every_rank_gives_one_rank_tokens(runs, name):
    """``serve`` at the layout: every rank returns every request's tokens,
    the same as the one-rank ``serve`` on rank 0."""
    _, ranks = runs
    want = ranks[0][f"{name}.serve_one_rank"]
    for r, got in enumerate(ranks):
        assert np.array_equal(got[f"{name}.serve"], want), (name, r)
