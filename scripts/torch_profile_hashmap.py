#!/usr/bin/env python3
"""Where the time of the port's hash-map main path goes, on one card.

    python3 scripts/torch_profile_hashmap.py [--out build/profile]

Runs chip_smoke.py's main path (same sizes, seed and data) once with the
kernels to warm up, then once more under ``torch.profiler`` and prints:
  * wall time of the profiled run and the device's busy share (the sum
    of kernel and memcpy/memset times over the wall time; one stream,
    so they do not overlap);
  * device time by kernel name, largest first, and the time of the
    five hand-written kernels.
The Chrome trace and the full table are written under ``--out``.
``--cpu-rehearsal`` runs the tiny CPU sizes (CPU activity only).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

#: name fragments of the port's kernels as the profiler lists them
PORT_KERNELS = ("bo_count", "bo_scan", "bo_rank", "pack_rows_kernel", "copy_words",
                "place_rows_kernel", "insert_arrivals_kernel", "find_arrivals_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("torch_profile_hashmap: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu_rehearsal else "cuda")
    sz = chip_smoke.REHEARSAL if args.cpu_rehearsal else chip_smoke.FULL
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda":
        print(chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.build.build()
    data = chip_smoke.workload(sz, dev, 0)
    chip_smoke.main_path("auto", sz, data, dev)          # warm-up

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = chip_smoke.main_path("auto", sz, data, dev)
        wall = time.perf_counter() - t0
    chip_smoke.check_oracle(r, data, sz)

    # device activities only (kernels, memcpy, memset): the aten ops that
    # launch them carry the same device time and would count it twice
    device = dev.type == "cuda"
    want = DeviceType.CUDA if device else DeviceType.CPU
    rows = []
    for ev in prof.key_averages():
        t = ev.self_device_time_total if device else ev.self_cpu_time_total
        if t > 0 and ev.device_type == want:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(t for t, _, _ in rows) if device else float("nan")
    ours = sum(t for t, _, k in rows if any(p in k for p in PORT_KERNELS))
    print(f"profiled main path: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), port kernels {ours:.1f} ms", flush=True)
    print(f"{'ms':>10} {'calls':>7}  name", flush=True)
    for t, n, k in rows[:25]:
        print(f"{t:10.3f} {n:7d}  {k[:100]}", flush=True)
    with open(out / "by_op.txt", "w") as f:
        for t, n, k in rows:
            f.write(f"{t:.4f}\t{n}\t{k}\n")
    prof.export_chrome_trace(str(out / "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
