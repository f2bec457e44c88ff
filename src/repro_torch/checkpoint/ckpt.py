"""Fault-tolerant checkpointing: atomic, verified, retained, async
(the port of ``repro/checkpoint/ckpt.py``).

Layout (one directory per step), as the JAX package writes it:

  <dir>/step_000000123.tmp/        written first
      index.json                   step, leaf count, each leaf's shape and dtype
      arr_0.npz                    every leaf, ``leaf_<i>``
      checksums.json               crc32 of each leaf's stored bytes
  <dir>/step_000000123/            atomic rename on completion

  * atomicity: readers only ever see fully renamed directories;
  * integrity: every leaf is verified against ``checksums.json`` on
    restore; a torn or bit-rotted archive raises
    :class:`CheckpointCorruptError`, and ``CheckpointManager.restore_latest``
    falls back to the newest intact step;
  * retention: keep the newest ``keep`` checkpoints;
  * async: ``CheckpointManager`` copies the tree to the host on the
    caller's thread and writes it on a background thread.

Leaves are numbered in the port's tree order (``repro_torch.tree``: a
dict's entries by sorted key, a list's by index, depth first).  A tensor
leaf is stored as its numpy array; a bf16 leaf, which numpy cannot hold
without ``ml_dtypes``, as its raw 16-bit words (``uint16``), with
``bfloat16`` as its dtype in ``index.json``; the crc32 is taken over the
stored bytes.  A non-tensor leaf (the token stream's integers) is stored
as a 0-d numpy array.  Restore gives each tensor leaf back on the device
and in the dtype of the ``like`` tree's leaf there, and each other leaf as
a numpy array.  Reading a checkpoint the JAX package wrote is not
supported (its leaf order and bf16 encoding differ).  Multi-rank training
(ROADMAP Queue 1 item 7d) writes one archive per rank's shards.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_mod


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed its integrity check on restore."""


def _stored(leaf) -> tuple[np.ndarray, str]:
    """(the array written for ``leaf``, the dtype named in index.json)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)    # a snapshot, also of a CPU tensor
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_checksums(arrays: dict[str, np.ndarray]) -> dict[str, int]:
    """crc32 over each leaf's stored bytes (shape/dtype pinned by index.json)."""
    return {k: zlib.crc32(np.ascontiguousarray(v).tobytes()) for k, v in arrays.items()}


def _host(tree: Any) -> list[tuple[np.ndarray, str]]:
    """What is written for each leaf of ``tree``, in leaf order."""
    return [_stored(x) for x in tree_mod.leaves(tree)]


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write ``tree`` (tensors on any device, numbers) as step ``step``."""
    return _write(directory, step, _host(tree), keep)


def _write(directory: str, step: int, stored: list, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    index = {"step": step, "n_leaves": len(stored), "leaves": []}
    arrays = {}
    for i, (arr, dtype) in enumerate(stored):
        arrays[f"leaf_{i}"] = arr
        index["leaves"].append({"i": i, "shape": list(arr.shape), "dtype": dtype})
    np.savez(os.path.join(tmp, "arr_0.npz"), **arrays)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    # integrity sidecar: per-leaf crc32 verified on restore
    with open(os.path.join(tmp, "checksums.json"), "w") as f:
        json.dump(_leaf_checksums(arrays), f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    _retain(directory, keep)
    return final


def _restored(arr: np.ndarray, dtype: str, ref):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif isinstance(ref, torch.Tensor):
        t = torch.from_numpy(arr)
    else:
        return arr
    if not isinstance(ref, torch.Tensor):
        return t.float().numpy()
    return t.to(device=ref.device, dtype=ref.dtype)


def restore_checkpoint(directory: str, step: int | None, like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (the newest step if ``step``
    is None); returns (tree, step).  Every leaf is verified against the
    ``checksums.json`` sidecar: a torn file, a truncated archive or a
    bit-rotted array raises :class:`CheckpointCorruptError`; a different
    leaf count raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    try:
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        with np.load(os.path.join(path, "arr_0.npz")) as data:
            arrays = {k: data[k] for k in data.files}
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile, zlib.error) as e:
        raise CheckpointCorruptError(f"checkpoint {path} is unreadable: {e}") from e
    ck_path = os.path.join(path, "checksums.json")
    if os.path.exists(ck_path):
        with open(ck_path) as f:
            want = json.load(f)
        got = _leaf_checksums(arrays)
        bad = sorted(k for k in want if got.get(k) != want[k])
        if bad or set(want) != set(got):
            raise CheckpointCorruptError(
                f"checkpoint {path} failed integrity check "
                f"(leaves {bad or sorted(set(want) ^ set(got))})")

    leaves_like = tree_mod.leaves(like)
    if index["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {index['n_leaves']} leaves, expected "
                         f"{len(leaves_like)}: structure changed")
    new_leaves = [_restored(arrays[f"leaf_{i}"], index["leaves"][i]["dtype"], ref)
                  for i, ref in enumerate(leaves_like)]
    return tree_mod.unflatten(like, new_leaves), step


def all_steps(directory: str) -> list[int]:
    """Published checkpoint steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return max(steps) if steps else None


def _retain(directory: str, keep: int) -> None:
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)


class CheckpointManager:
    """Async save + restore-latest convenience with retention."""

    def __init__(self, directory: str, keep: int = 3, save_interval: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree: Any, blocking: bool = False) -> bool:
        if step % self.save_interval:
            return False
        self.wait()
        # the copy to the host on the caller's thread (the tree may change
        # in place after this returns), the IO on the worker
        stored = _host(tree)
        if blocking:
            _write(self.directory, step, stored, self.keep)
        else:
            self._thread = threading.Thread(
                target=_write, args=(self.directory, step, stored, self.keep), daemon=True)
            self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like):
        """Restore the newest INTACT checkpoint: a corrupt newest step falls
        back to the next-newest step that passes its integrity check.
        Raises the newest step's :class:`CheckpointCorruptError` only when
        every retained checkpoint is corrupt."""
        self.wait()
        steps = all_steps(self.directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        first_err: CheckpointCorruptError | None = None
        for step in reversed(steps):
            try:
                return restore_checkpoint(self.directory, step, like)
            except CheckpointCorruptError as e:
                first_err = first_err or e
        raise first_err
