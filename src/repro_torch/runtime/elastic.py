"""Elastic scaling: recompute the mesh after node loss/gain (the port of
``repro/runtime/elastic.py``).

Policy: keep the 'model' axis intact (TP/EP layouts are weight-resident
and expensive to reshape) and shrink/grow the data axes — drop whole
data rows so the remaining device grid stays rectangular.  The data
stream is a pure function of (seed, step, shard), so rebalancing shards
is just renumbering.  ``plan_remesh`` is plain arithmetic and is the JAX
package's.  ``make_elastic_mesh`` builds a ``models/sharding.Layout`` over
the live ranks, which needs a process group over the survivors and each
rank's shards restored onto it: it comes with multi-rank training
(ROADMAP Queue 1 item 7d).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_devices: int
    batch_per_shard_scale: float   # growth factor of per-shard batch


def plan_remesh(axis_names: tuple[str, ...], old_shape: tuple[int, ...],
                available_devices: int) -> ElasticPlan:
    """Largest rectangular mesh with the model axis preserved."""
    names = list(axis_names)
    shape = list(old_shape)
    model_idx = names.index("model") if "model" in names else len(names) - 1
    model = shape[model_idx]
    if available_devices < model:
        raise ValueError("cannot preserve the model axis: "
                         f"{available_devices} < model={model}")
    data_total = 1
    for i, s in enumerate(shape):
        if i != model_idx:
            data_total *= s
    new_data_total = available_devices // model
    # fold into the existing data axes, last axis absorbs the remainder
    new_shape = list(shape)
    remaining = new_data_total
    for i in range(len(shape)):
        if i == model_idx:
            continue
        new_shape[i] = min(shape[i], remaining)
        while new_shape[i] > 1 and remaining % new_shape[i]:
            new_shape[i] -= 1
        remaining //= max(new_shape[i], 1)
    # put any leftover factor on the first data axis
    used = 1
    for i, s in enumerate(new_shape):
        if i != model_idx:
            used *= s
    first_data = next(i for i in range(len(shape)) if i != model_idx)
    new_shape[first_data] *= max(new_data_total // used, 1)

    return ElasticPlan(tuple(old_shape), tuple(new_shape),
                       tuple(axis_names),
                       dropped_devices=available_devices -
                       model * new_data_total,
                       batch_per_shard_scale=data_total / new_data_total)

