"""The port's runtime: checkpoints, fault tolerance and the elastic remesh.

The checkpoint cases of ``tests/test_substrate.py`` run against the port
(round trip with bf16 and int leaves, retention, no ``.tmp`` visible, a
structure mismatch, a corrupt leaf, a torn archive, ``restore_latest``
falling back to the intact step, the async save), with the on-disk layout
checked: ``index.json`` names ``bfloat16`` for a bf16 leaf stored as its
16-bit words, and ``checksums.json`` holds the crc32 of each stored leaf.
``FaultToleranceManager``, ``StragglerDetector`` and ``plan_remesh`` take
the same decisions as the JAX package's on the same heartbeat and
step-time sequences and on ``test_substrate.py``'s rectangular sweep.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

from repro.runtime import elastic as jelastic
from repro.runtime import ft as jft
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import ft as tft
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _npz(tmp_path, step):
    return os.path.join(str(tmp_path), f"step_{step:09d}", "arr_0.npz")


def _flip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_save_restore_roundtrip_bf16(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.arange(10, dtype=torch.int32),
            "b": {"c": torch.randn(3, 5, generator=gen).to(torch.bfloat16)},
            "layers": [torch.randn(4, generator=gen), torch.zeros((), dtype=torch.int32) + 5],
            "stream": {"step": 7, "seed": 3}}
    save_checkpoint(str(tmp_path), 5, tree)
    like = {"a": torch.zeros(10, dtype=torch.int32),
            "b": {"c": torch.zeros(3, 5, dtype=torch.bfloat16)},
            "layers": [torch.zeros(4), torch.zeros((), dtype=torch.int32)],
            "stream": {"step": 0, "seed": 0}}
    got, step = restore_checkpoint(str(tmp_path), None, like)
    assert step == 5
    assert got["b"]["c"].dtype == torch.bfloat16 and torch.equal(got["b"]["c"], tree["b"]["c"])
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["layers"][0], tree["layers"][0])
    assert int(got["layers"][1]) == 5 and int(got["stream"]["step"]) == 7
    path = os.path.join(str(tmp_path), "step_000000005")
    index = json.load(open(os.path.join(path, "index.json")))
    # leaves in the port's tree order: a, b.c, layers[0], layers[1], stream.seed, stream.step
    assert [leaf["dtype"] for leaf in index["leaves"]] == \
        ["int32", "bfloat16", "float32", "int32", "int64", "int64"]
    with np.load(os.path.join(path, "arr_0.npz")) as data:
        words = data["leaf_1"]
        sums = json.load(open(os.path.join(path, "checksums.json")))
        assert words.dtype == np.uint16
        assert sums["leaf_1"] == zlib.crc32(words.tobytes())
    assert np.array_equal(words, tree["b"]["c"].view(torch.int16).numpy().view(np.uint16))


def test_retention(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(4)}, keep=2)
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [4, 5]


def test_atomic_no_tmp_visible(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 1


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4), "y": torch.zeros(2)})


def test_corrupt_leaf_detected(tmp_path):
    tree = {"x": torch.arange(16)}
    save_checkpoint(str(tmp_path), 1, tree)
    _flip(_npz(tmp_path, 1))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(str(tmp_path), 1, tree)


def test_torn_checkpoint_detected(tmp_path):
    tree = {"x": torch.arange(16)}
    save_checkpoint(str(tmp_path), 1, tree)
    data = open(_npz(tmp_path, 1), "rb").read()
    open(_npz(tmp_path, 1), "wb").write(data[:len(data) // 2])    # truncated write
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(str(tmp_path), 1, tree)


def test_restore_latest_falls_back_to_intact(tmp_path):
    save_checkpoint(str(tmp_path), 5, {"x": torch.full((8,), 5, dtype=torch.int32)})
    save_checkpoint(str(tmp_path), 9, {"x": torch.full((8,), 9, dtype=torch.int32)})
    _flip(_npz(tmp_path, 9))
    mgr = CheckpointManager(str(tmp_path))
    got, step = mgr.restore_latest({"x": torch.zeros(8, dtype=torch.int32)})
    assert step == 5 and torch.equal(got["x"], torch.full((8,), 5, dtype=torch.int32))
    _flip(_npz(tmp_path, 5))                      # both corrupt: the newest's error
    with pytest.raises(CheckpointCorruptError, match="step_000000009"):
        mgr.restore_latest({"x": torch.zeros(8, dtype=torch.int32)})


def test_async_save_snapshots_the_tree(tmp_path):
    """The manager copies the tree before it returns (the caller updates its
    tensors in place), writes on its thread, and skips off-interval steps."""
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval=2)
    x = torch.arange(6, dtype=torch.float32)
    assert not mgr.maybe_save(1, {"x": x})
    assert mgr.maybe_save(2, {"x": x})
    x.add_(100)                                   # in place, as adamw_update writes
    assert mgr.maybe_save(4, {"x": x})
    mgr.wait()
    got2, _ = restore_checkpoint(str(tmp_path), 2, {"x": torch.zeros(6)})
    got4, _ = mgr.restore_latest({"x": torch.zeros(6)})
    assert torch.equal(got2["x"], torch.arange(6.0)) and torch.equal(got4["x"], x)


def _decisions(mod, script):
    """Run a heartbeat script through a package's manager; its decisions and
    the nodes' health after each tick."""
    ft = mod.FaultToleranceManager(n_nodes=5, n_spares=1, heartbeat_interval=1.0,
                                   timeout_beats=2)
    out = []
    for now, beats, ckpt in script:
        for n in beats:
            ft.heartbeat(n, now)
        dec = ft.tick(now, last_ckpt_step=ckpt)
        out.append((dataclasses.asdict(dec),
                    {i: (s.health.value, s.missed, s.last_heartbeat) for i, s in ft.nodes.items()},
                    ft.healthy_nodes()))
    return out


def test_fault_tolerance_same_decisions():
    script = [(0.0, [0, 1, 2, 3], 0), (0.5, [0, 1, 2, 3], 0), (1.6, [0, 1, 2], 3),
              (2.2, [0, 1], 4), (3.1, [0, 1], 5), (3.5, [0, 1, 4], 6), (4.4, [0, 1, 4], 7),
              (6.0, [4], 8), (6.5, [0, 1, 4], 9)]
    assert _decisions(tft, script) == _decisions(jft, script)


def test_straggler_detector_same_flags():
    rng = np.random.default_rng(5)
    dets = [mod.StragglerDetector(n_nodes=8, threshold=2.0) for mod in (tft, jft)]
    assert dets[0].stragglers() == [] and dets[0].mitigation(0) == dets[1].mitigation(0)
    for step in range(40):
        times = 1.0 + rng.random(8) * 0.02
        times[5] += 1.5 if step > 10 else 0.0
        times[2] += 0.4 if 20 < step < 30 else 0.0
        for n in range(8):
            for det in dets:
                det.observe(n, float(times[n]))
        got, want = (d.stragglers() for d in dets)
        assert got == want
        assert [dets[0].mitigation(n) for n in range(8)] == \
            [dets[1].mitigation(n) for n in range(8)]
    assert 5 in got


REMESH = [(("data", "model"), (8, 4)), (("pod", "data", "model"), (2, 16, 16)),
          (("replica", "data"), (4, 2))]


def test_plan_remesh_same_plans():
    for names, shape in REMESH:
        _same_plans(names, shape)


def _same_plans(names, shape):
    for avail in range(1, int(np.prod(shape)) + 3):
        try:
            want = jelastic.plan_remesh(names, shape, avail)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                telastic.plan_remesh(names, shape, avail)
            continue
        got = telastic.plan_remesh(names, shape, avail)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert int(np.prod(got.new_shape)) + got.dropped_devices == avail
