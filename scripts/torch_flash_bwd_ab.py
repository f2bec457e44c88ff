#!/usr/bin/env python3
"""Two checkouts' attention backward kernels on the same inputs, in turns, on one card.

    python3 scripts/torch_flash_bwd_ab.py ROOT_A [ROOT_B] [--rounds 1] [--reps 10] \
        [--case stablelm_train ...]

The A B B A driver is ``kernel_ab.py``'s (its docstring says how the
checkouts are run).  The cases and the measurement are ``chip_smoke.py``'s
backward phase (``BWD_FULL``, ``bwd_phase``) from this script's checkout,
run on the ``repro_torch`` of the checkout timed: each case one call of
``flash_attention_bwd`` against autograd through the plain version at the
phase's gates, a second launch bit for bit, the GQA fault, the kernel's ms
by CUDA events over ``--reps`` launches and its device ms by launch, the
plain version's and ``scaled_dot_product_attention``'s backward ms.
"""

from __future__ import annotations

import sys
from pathlib import Path

from kernel_ab import main

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's chip_smoke.py.  A worker imports the timed checkout's
    repro_torch (its PYTHONPATH) first, so that chip_smoke's own src, which
    it puts first on sys.path, does not take its place."""
    try:
        import repro_torch  # noqa: F401
    except ImportError:     # the A B B A loop itself: no checkout on PYTHONPATH
        pass
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def worker(cases: list[str], reps: int) -> dict:
    """``bwd_phase`` on ``cases`` with the kernels found on ``sys.path``, at
    chip_smoke's precision settings."""
    import torch
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return cs.bwd_phase({c: cs.BWD_FULL[c] for c in cases}, reps, torch.device("cuda"), 0)


if __name__ == "__main__":
    sys.exit(main(__file__, __doc__, _chip_smoke().BWD_FULL, worker, reps=10, rounds=1))
