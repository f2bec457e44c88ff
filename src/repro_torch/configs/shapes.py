"""Assigned input shapes (the port's copy of ``repro.configs.shapes``).

Four shapes per LM architecture (assignment):
  train_4k      seq 4,096    global_batch 256    lowers train_step
  prefill_32k   seq 32,768   global_batch 32     lowers prefill
  decode_32k    seq 32,768   global_batch 128    lowers decode_step
  long_500k     seq 524,288  global_batch 1      lowers decode_step
                (sub-quadratic archs only; skips recorded in the table)

:func:`repro_torch.data.synth_batch` reads them.  ``input_specs`` (the
JAX dry run's ``ShapeDtypeStruct`` stand-ins) waits for the port of the
JAX tooling (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic mixing (DESIGN.md section 6)")
    return True, ""
