"""Carry hash-map state between the JAX package and the port.

``repro.containers.hashmap.export_state`` returns a dict of u32 arrays;
with ``np.asarray`` applied to each, :func:`hashmap_state_from_numpy`
turns it into the port's ``HashMapState`` (int32 bit-views on
``device``), and :func:`hashmap_state_to_numpy` goes back to u32
numpy arrays.  This is the system's "weights carried across": both
packages can start from the same populated table.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.containers.hashmap import HashMapState

_FIELDS = ("tkeys", "tvals", "status")


def hashmap_state_from_numpy(exported: dict, device="cuda") -> HashMapState:
    """u32 numpy arrays ``{tkeys, tvals, status}`` -> port state on ``device``."""
    return HashMapState(*(
        torch.from_numpy(np.array(exported[k], dtype=np.uint32).view(np.int32)).to(device)
        for k in _FIELDS))


def hashmap_state_to_numpy(state: HashMapState) -> dict:
    """Port state -> ``{tkeys, tvals, status}`` u32 numpy arrays."""
    return {k: getattr(state, k).cpu().numpy().view(np.uint32) for k in _FIELDS}
