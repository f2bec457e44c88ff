#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one card.

    python3 scripts/torch_profile_hashmap.py [--path hashmap|genomics|ext|serving] \
        [--out build/profile]

Runs one of chip_smoke.py's paths (same sizes, seed and data: the
hash-map path by default, the genomics path, or the extensions path:
integrity under a corrupted wire, heal, degraded probe, hierarchical vs
dense transport, split-phase find_insert) once with the kernels
to warm up, then once more under ``torch.profiler``.  ``--path serving``
profiles two windows of the serving path's qwen3-4b instead, after a
warm-up: one prefill of a wave (8 x 2048 tokens, to its greedy pick)
and 8 decode steps of that wave.  For each run it prints:
  * wall time of the profiled run and the device's busy share (the sum
    of kernel and memcpy/memset times over the wall time; one stream,
    so they do not overlap);
  * device time by kernel name, largest first, the time of the port's
    hand-written kernels, and the time and launches of bin_csr's kernels
    (its memsets are not told apart from the path's others).
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
PORT_KERNELS = ("bo_count", "bo_scan", "bo_rank", *chip_smoke.CSR_KERNELS,
                "pack_rows_kernel", "copy_words", "place_rows_kernel",
                "probe_insert_blocks", "probe_find_blocks", "probe_find_queries",
                "membership_kernel", "hash_words_kernel", "row_mix_kernel",
                "ragged_slots_kernel", "histogram_kernel", "flash_fwd_tf32",
                "flash_fwd_wgmma")


def serving_windows(dev, rehearsal: bool) -> list:
    """(name, set-up, profiled drive) of the serving path's two windows."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    vz = chip_smoke.V_REHEARSAL if rehearsal else chip_smoke.V_FULL
    sv = chip_smoke.serving_setup(vz, dev, 0)
    cfg, params = sv["cfg"], sv["params"]
    prompts = sv["prompts"][:vz["batch"]]
    prefill = make_prefill_step(cfg, cache_len=vz["prompt_len"] + vz["gen"])
    decode = make_serve_step(cfg)
    state = {}

    def run_prefill():
        state["cache"], logits = prefill(params, {"tokens": prompts})
        state["tok"] = logits.argmax(-1)[:, None]
        chip_smoke.sync(dev)

    def run_decode():
        for _ in range(8):
            logits, state["cache"] = decode(params, state["cache"], state["tok"])
            state["tok"] = logits.argmax(-1)[:, None]
        chip_smoke.sync(dev)

    return [("serving prefill", lambda: None, run_prefill),
            ("serving decode x8", run_prefill, run_decode)]


def profile_window(name: str, drive, dev, out: Path):
    """Profile one run of ``drive``; print its busy share and top kernels."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = drive()
        wall = time.perf_counter() - t0

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
    print(f"profiled {name}: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), port kernels {ours:.1f} ms", flush=True)
    csr = [(t, n) for t, n, k in rows if any(c in k for c in chip_smoke.CSR_KERNELS)]
    print(f"bin_csr kernels: {sum(t for t, _ in csr):.3f} ms over "
          f"{sum(n for _, n in csr)} launches (memsets not included)", flush=True)
    print(f"{'ms':>10} {'calls':>7}  name", flush=True)
    for t, n, k in rows[:25]:
        print(f"{t:10.3f} {n:7d}  {k[:100]}", flush=True)
    tag = name.replace(" ", "_")
    with open(out / f"{tag}_by_op.txt", "w") as f:
        for t, n, k in rows:
            f.write(f"{t:.4f}\t{n}\t{k}\n")
    prof.export_chrome_trace(str(out / f"{tag}_trace.json"))
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("hashmap", "genomics", "ext", "serving"),
                    default="hashmap")
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
    if args.path == "serving":
        for name, setup, drive in serving_windows(dev, args.cpu_rehearsal):
            setup()
            drive()                                     # warm-up
            setup()
            profile_window(name, drive, dev, out)
        return 0
    if args.path == "hashmap":
        data = chip_smoke.workload(sz, dev, 0)
        drive = lambda: chip_smoke.main_path("auto", sz, data, dev)  # noqa: E731
        oracle = lambda r: chip_smoke.check_oracle(r, data, sz)  # noqa: E731
    elif args.path == "ext":
        xz = chip_smoke.X_REHEARSAL if args.cpu_rehearsal else chip_smoke.X_FULL
        data = chip_smoke.ext_workload(xz, dev, 0)
        drive = lambda: chip_smoke.ext_path("auto", xz, data, dev)  # noqa: E731
        oracle = lambda r: chip_smoke.check_ext(r, data, xz)  # noqa: E731
    else:
        gz = chip_smoke.G_REHEARSAL if args.cpu_rehearsal else chip_smoke.G_FULL
        data = chip_smoke.genomics_workload(gz, dev, 0)
        drive = lambda: chip_smoke.genomics_path("auto", gz, data, dev)  # noqa: E731
        oracle = lambda r: chip_smoke.check_genomics(r, data, gz)  # noqa: E731
    drive()                                             # warm-up
    r = profile_window(f"{args.path} path", drive, dev, out)
    oracle(r)
    if args.path != "hashmap":
        print("phase seconds: " + " ".join(f"{k}={v:.4f}" for k, v in r["times"].items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
