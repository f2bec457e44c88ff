"""Run ``chip_smoke.py``'s multi-rank cells alone: the build, then each
cell's one-rank reference and its four gloo ranks on the one card, with
every gate of the full script.

    python3 scripts/torch_multirank_cells.py [ARCH ...]        # on the card
    python3 scripts/torch_multirank_cells.py --cpu [ARCH ...]  # the CPU rehearsal's cells

With no ARCH every cell of ``MR_FULL`` (``MR_REHEARSAL`` with ``--cpu``)
runs; an ARCH picks the cells of that architecture.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    rehearsal = "--cpu" in sys.argv
    names = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not rehearsal and not torch.cuda.is_available():
        print("torch_multirank_cells: no CUDA device (pass --cpu)", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if rehearsal else "cuda")
    if not rehearsal:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        t0 = time.perf_counter()
        cs.build.build()
        print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = "" if rehearsal else cs.nvidia_smi()
    for mz in (cs.MR_REHEARSAL if rehearsal else cs.MR_FULL):
        if not names or mz["arch"] in names:
            cs.multirank_cell(mz, dev, 0, smi, rehearsal)
    print("mr cells done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
