"""Learning-rate schedules (the port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float = 1.0, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1):
    """Multiplier in [floor*peak, peak]; pass as lr_scale to adamw_update.

    ``step`` a tensor: a float32 tensor on its device, computed in float32
    as the JAX package computes it.  ``step`` a Python number: a Python
    float of the same float32 value."""
    as_tensor = isinstance(step, torch.Tensor)
    s = step.float() if as_tensor else torch.tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    out = peak * warm * cos
    return out if as_tensor else float(out)
