"""Carry container state between the JAX package and the port.

The JAX containers' states are dicts or NamedTuples of u32/i32 arrays;
with ``np.asarray`` applied to each field, the ``*_from_numpy`` helpers
turn them into the port's states (int32 bit-views on ``device``), and
the ``*_to_numpy`` helpers go back to numpy arrays of the JAX dtypes
(u32 words, i32 cursors).  This is the system's "weights carried
across": both packages can start from the same populated containers.

  hash map  ``repro.containers.hashmap.export_state`` -> {tkeys, tvals, status}
  queue     ``repro.containers.queue.export_state``   -> {data, head, tail,
                                                          tail_ready, head_ready}
  Bloom     ``BloomState._asdict()``                  -> {words}
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.containers.bloom import BloomState
from repro_torch.containers.hashmap import HashMapState
from repro_torch.containers.queue import QueueState

_MAP = ("tkeys", "tvals", "status")
_QUEUE = ("data", "head", "tail", "tail_ready", "head_ready")


def _words(a, device) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=np.uint32 if a.dtype == np.uint32
                                     else np.int32).view(np.int32)).to(device)


def hashmap_state_from_numpy(exported: dict, device="cuda") -> HashMapState:
    """u32 numpy arrays ``{tkeys, tvals, status}`` -> port state on ``device``."""
    return HashMapState(*(_words(exported[k], device) for k in _MAP))


def hashmap_state_to_numpy(state: HashMapState) -> dict:
    """Port state -> ``{tkeys, tvals, status}`` u32 numpy arrays."""
    return {k: getattr(state, k).cpu().numpy().view(np.uint32) for k in _MAP}


def queue_state_from_numpy(exported: dict, device="cuda") -> QueueState:
    """``{data (u32), head, tail, tail_ready, head_ready (i32)}`` -> port state."""
    return QueueState(*(_words(exported[k], device) for k in _QUEUE))


def queue_state_to_numpy(state: QueueState) -> dict:
    """Port state -> ``{data}`` u32 and the four i32 cursors as numpy."""
    out = {k: getattr(state, k).cpu().numpy() for k in _QUEUE}
    out["data"] = out["data"].view(np.uint32)
    return out


def bloom_state_from_numpy(exported: dict, device="cuda") -> BloomState:
    """``{words}`` (nb, 2) u32 -> port state on ``device``."""
    return BloomState(_words(exported["words"], device))


def bloom_state_to_numpy(state: BloomState) -> dict:
    """Port state -> ``{words}`` (nb, 2) u32 numpy."""
    return {"words": state.words.cpu().numpy().view(np.uint32)}
