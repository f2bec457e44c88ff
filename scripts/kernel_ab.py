"""Two checkouts' kernels on the same inputs, in turns, on one card: the shared driver.

A kernel family's script (``torch_flash_ab.py``, ``torch_scan_ab.py``)
holds its cases and a worker that times them with the kernels found on
``sys.path``, and hands both to :func:`main`:

    python3 scripts/<family>_ab.py ROOT_A [ROOT_B] [--rounds R] [--reps N] \
        [--case NAME ...]

ROOT_A and ROOT_B are checkouts of this repo (``git archive`` of two
trees, say; ROOT_B may be left out to time one tree).  Each measurement
runs in a fresh process with ``ROOT/src`` on its path, so each checkout
builds and loads its own ``csrc/*.cu`` (under ``ROOT/build/kernels``).
The order is A, B, B, A for each round, so that a drift of the card's
clocks falls on both.  The first line names the card and its power limit;
each worker row is printed as it comes; the last line is a JSON object:
per case, each checkout's rows in the order they ran.

This module imports only ``torch`` (in :func:`host_us`), so it is read
from the script's own checkout whichever checkouts are timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call, over n calls enqueued back to back (the
    launch queue does not fill), synchronised after the clock stops."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e6


def main(script: str, doc: str, cases: dict, worker, reps: int, rounds: int) -> int:
    """The command line of the family script ``script`` (its ``__file__``):
    with ``--worker``, ``worker(case names, reps)`` on the checkout put on
    ``sys.path`` by its caller, its rows printed as one JSON line;
    otherwise the A B B A turns over the checkouts given."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--case", nargs="+", default=list(cases), choices=list(cases))
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--rounds", type=int, default=rounds)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.case, args.reps)), flush=True)
        return 0
    if len(args.roots) not in (1, 2):
        ap.error("one or two checkout roots")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    roots = [r.resolve() for r in args.roots]
    order = roots + roots[::-1] if len(roots) == 2 else roots
    results: dict = {c: {str(r): [] for r in roots} for c in args.case}
    for _ in range(args.rounds):
        for root in order:
            cmd = [sys.executable, str(Path(script).resolve()), "--worker", "--reps",
                   str(args.reps), "--case", *args.case]
            res = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=str(root / "src")),
                                 cwd=root, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(f"{root}: worker failed ({res.returncode}):\n{res.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            for c, row in json.loads(res.stdout.strip().splitlines()[-1]).items():
                results[c][str(root)].append(row)
                print(f"{root} {c}: {json.dumps(row)}", flush=True)
    print(json.dumps(results), flush=True)
    return 0
