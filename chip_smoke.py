#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with a card
    python3 chip_smoke.py --cpu-rehearsal # tiny sizes, plain versions, CPU

Phases, each fatal on failure:
  1. the card: nvidia-smi name and power limit, device name and count;
  2. build the five CUDA kernels from src/repro_torch/csrc (ptxas report);
  3. kernel phase: a short probe of the main path records each kernel's
     largest call; each kernel is held against its plain PyTorch version
     on those inputs (bit equality: every output is integer) and timed
     beside its plain version, its byte bound and, where one exists, one
     PyTorch call computing the same function;
  4. main path: a 2**26-bucket hash map (block 64, u32 keys and values)
     takes 4 insert waves of 2**23 keys (one wave with ~1% duplicates),
     a speculative find of 2**23 keys (half absent) and a find_insert of
     2**22 + 2**22, through the port's entry points on a SerialBackend;
     run with the kernels (launch counts reset just before, read just
     after) and with the plain versions, and held against each other and
     against the key/value oracle.
The last line is {"ok": true, "device": {...}}; the line before it the
nvidia-smi name and power limit; before that the kernels' JSON line.
Without a CUDA device (and without --cpu-rehearsal) it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# the port; a lone copy of this script fails here
from repro_torch.containers import hashmap as hm  # noqa: E402
from repro_torch.core.backend import SerialBackend  # noqa: E402
from repro_torch.core.hashing import fmix32  # noqa: E402
from repro_torch.core.object_container import Spec  # noqa: E402
from repro_torch.core.u32 import as_u64, to_i32  # noqa: E402
from repro_torch.kernels import binning, build, hash_probe  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
OPS_PER_S = 67e12           # H100 SXM 32-bit rate outside the tensor cores (float32)

FULL = dict(capacity=1 << 26, block=64, wave=1 << 23, waves=4, find=1 << 23,
            fi=1 << 22, reps=10)
REHEARSAL = dict(capacity=1 << 12, block=64, wave=1 << 9, waves=4, find=1 << 9,
                 fi=1 << 8, reps=2)

# name -> (module, wrapper, plain, source, TPU kernel it replaces)
KERNELS = {
    "bin_offsets": (binning, "bin_offsets", "bin_offsets_plain",
                    "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:72"),
    "pack_rows": (binning, "pack_rows", "pack_rows_plain",
                  "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:229"),
    "place_rows": (binning, "place_rows", "place_rows_plain",
                   "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:300"),
    "insert_arrivals": (hash_probe, "insert_arrivals", "insert_arrivals_plain",
                        "src/repro_torch/csrc/hash_probe.cu",
                        "src/repro/kernels/hash_probe.py:246"),
    "find_arrivals": (hash_probe, "find_arrivals", "find_arrivals_plain",
                      "src/repro_torch/csrc/hash_probe.cu",
                      "src/repro/kernels/hash_probe.py:406"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# data: distinct u32 keys as fmix32 of disjoint counter ranges (a bijection)
# --------------------------------------------------------------------------

def keys_at(start: int, n: int, dev) -> torch.Tensor:
    ctr = to_i32(torch.arange(start, start + n, dtype=torch.int64, device=dev))
    return fmix32(ctr)


def value_of(keys: torch.Tensor) -> torch.Tensor:
    return to_i32(as_u64(keys) * 3 + 1)


def workload(sz: dict, dev, seed: int) -> dict:
    """Keys of every phase, from the seed; int32 words."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    wave, n_in = sz["wave"], sz["wave"] * sz["waves"]
    waves = [keys_at(w * wave, wave, dev) for w in range(sz["waves"])]
    # ~1% in-wave duplicates in wave 1: copies of earlier keys of the wave
    ndup = wave // 100
    pos = torch.randperm(wave - wave // 2, generator=gen)[:ndup] + wave // 2
    src = torch.randint(0, wave // 2, (ndup,), generator=gen)
    waves[1][pos.to(dev)] = waves[1][src.to(dev)]
    inserted = torch.unique(torch.cat(waves))
    absent0 = 1 << 31                        # counters no insert uses
    half, fhalf = sz["find"] // 2, sz["fi"] // 2
    pick = torch.randperm(inserted.numel(), generator=gen)[:half + fhalf].to(dev)
    return dict(
        waves=waves, n_distinct=int(inserted.numel()), n_in=n_in,
        find=torch.cat([inserted[pick[:half]], keys_at(absent0, half, dev)]),
        fi_find=torch.cat([inserted[pick[half:]], keys_at(absent0 + half, fhalf, dev)]),
        fi_ins=keys_at(n_in, sz["fi"], dev))


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def u32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint32)


def main_path(impl: str, sz: dict, data: dict, dev) -> dict:
    """The port's hash-map entry points at full width; results + timings."""
    bk = SerialBackend()
    spec, st = hm.hashmap_create(bk, sz["capacity"], Spec((), torch.uint32),
                                 Spec((), torch.uint32), block_size=sz["block"],
                                 impl=impl, device=dev)
    out = {"insert_s": [], "ok": []}
    sync(dev)
    for keys in data["waves"]:
        t0 = time.perf_counter()
        st, ok = hm.insert(bk, spec, st, u32(keys), u32(value_of(keys)),
                           capacity=keys.numel())
        sync(dev)
        out["insert_s"].append(time.perf_counter() - t0)
        out["ok"].append(ok)
    q = data["find"]
    t0 = time.perf_counter()
    st, vals, found = hm.find(bk, spec, st, u32(q), capacity=q.numel())
    sync(dev)
    out["find_s"] = time.perf_counter() - t0
    fk, ik = data["fi_find"], data["fi_ins"]
    t0 = time.perf_counter()
    st, fvals, ffound, fok = hm.find_insert(bk, spec, st, u32(fk), u32(ik),
                                            u32(value_of(ik)), capacity=ik.numel())
    sync(dev)
    out["find_insert_s"] = time.perf_counter() - t0
    out.update(state=st, vals=vals.view(torch.int32), found=found,
               fvals=fvals.view(torch.int32), ffound=ffound, fok=fok,
               count=int(hm.count_ready(bk, st)))
    return out


def check_oracle(r: dict, data: dict, sz: dict) -> None:
    """Every present key found with 3k+1, no absent key found, counts exact."""
    for w, ok in enumerate(r["ok"]):
        check(bool(ok.all()), f"insert wave {w}: every key lands")
    half, fhalf = sz["find"] // 2, sz["fi"] // 2
    check(bool(r["found"][:half].all()), "find: every present key found")
    check(not bool(r["found"][half:].any()), "find: no absent key found")
    check(torch.equal(r["vals"][:half], value_of(data["find"][:half])),
          "find: values are 3k+1")
    check(bool(r["ffound"][:fhalf].all()) and not bool(r["ffound"][fhalf:].any()),
          "find_insert: present found, absent not")
    check(torch.equal(r["fvals"][:fhalf], value_of(data["fi_find"][:fhalf])),
          "find_insert: values are 3k+1")
    want = data["n_distinct"] + int(r["fok"].sum())
    check(r["count"] == want, f"count_ready {r['count']} == distinct inserted {want}")


def same_results(a: dict, b: dict) -> None:
    for name in ("tkeys", "tvals", "status"):
        check(torch.equal(getattr(a["state"], name), getattr(b["state"], name)),
              f"kernel and plain runs: table {name} bit-identical")
    for name in ("found", "vals", "ffound", "fvals", "fok"):
        check(torch.equal(a[name], b[name]), f"kernel and plain runs: {name} identical")
    for w, (x, y) in enumerate(zip(a["ok"], b["ok"])):
        check(torch.equal(x, y), f"kernel and plain runs: wave {w} successes identical")


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def _work(name: str, args: tuple) -> int:
    """Size of one call, to keep the largest the main path makes."""
    if name == "bin_offsets":
        return int(args[2].sum())
    if name == "pack_rows":
        return int(args[4].sum())
    if name == "place_rows":
        return int((args[1] < args[0].numel()).sum()) * args[2].shape[1]
    return int(args[4].sum())                  # probes: valid arrivals


def capture_calls(sz: dict, data: dict, dev) -> dict:
    """Run two insert waves and one find, recording each kernel's largest call.

    Both the wrapper and the plain version are tapped: on the CPU
    (rehearsal) the dispatcher calls the plain version directly.
    """
    seen: dict[str, tuple] = {}
    originals = []
    for name, (mod, wrapper, plain, *_rest) in KERNELS.items():
        for attr in (wrapper, plain):
            fn = getattr(mod, attr)
            originals.append((mod, attr, fn))

            def tap(*args, _name=name, _fn=fn):
                w = _work(_name, args)
                if w >= seen.get(_name, (-1,))[0]:
                    seen[_name] = (w, args)
                return _fn(*args)
            setattr(mod, attr, tap)
    try:
        probe = dict(data, waves=data["waves"][:2])
        main_path("auto", dict(sz, waves=2), probe, dev)
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    check(set(seen) == set(KERNELS), f"probe reached every kernel: {sorted(seen)}")
    return {name: args for name, (_, args) in seen.items()}


def time_ms(fn, reps: int, dev) -> float:
    fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_bytes(name: str, args: tuple, out) -> int:
    """Bytes the function must move: each input read once, each output
    written once; the find reads only the blocks its queries touch."""
    outs = out if isinstance(out, tuple) else (out,)
    if name == "find_arrivals":
        tk, tv, st, seg, valid = args
        nb, bsz, lk = tk.shape
        lv = tv.shape[2]
        blocks = torch.unique(seg[:, 0][valid]).numel()
        hits = int(outs[0].sum())
        return (blocks * bsz * (lk + 1) * 4 + hits * lv * 4
                + seg.shape[0] * (1 + lk) * 4 + _nbytes(valid, *outs))
    if name == "insert_arrivals":
        tk, tv, st, seg, valid, _mode = args
        rows = seg.shape[0] * (1 + tk.shape[2] + tv.shape[2]) * 4
        return _nbytes(tk, tv, st, valid, *outs) + rows
    return _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *outs)


def bound_ops(name: str, args: tuple) -> int:
    """32-bit integer operations the function does on these inputs (a
    floor: compares, masks and address arithmetic per word or slot)."""
    if name == "bin_offsets":
        return 24 * args[0].numel()            # count, scan, ordered rank passes
    if name == "pack_rows":
        return 12 * args[0].numel()            # window test + slot per word
    if name == "place_rows":
        return 6 * args[2].numel() + args[0].numel()
    tk = args[0]
    probes = int(args[4].sum())
    return probes * tk.shape[1] * (tk.shape[2] + 3)   # key compare + state test per slot


def max_abs_err(a, b) -> int:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(len(a) == len(b), "kernel and plain return the same outputs")
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype, "same shapes and types")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function, where there is one:
    place_rows is ``Tensor.index_put`` of the landing words (the drop mask
    and word indices are prepared outside the timed call)."""
    if name != "place_rows":
        return None
    dst, slots, rows = args
    w = rows.shape[1]
    idx = slots.to(torch.int64)[:, None] + torch.arange(w, device=dst.device)
    keep = (slots[:, None] >= 0) & (idx < dst.numel())
    idx, vals = idx[keep], rows[keep]
    return lambda: dst.index_put((idx,), vals)


def kernel_phase(calls: dict, reps: int, dev) -> dict:
    rows = {}
    for name, (mod, wrapper, plain, _src, _rep) in KERNELS.items():
        args = calls[name]
        got = getattr(mod, wrapper)(*args)
        want = getattr(mod, plain)(*args)
        sync(dev)
        err = max_abs_err(got, want)
        check(err == 0, f"{name}: kernel equals its plain version bit for bit")
        lib = library_call(name, args)
        if lib is not None:
            check(torch.equal(lib(), got), f"{name}: library call computes the same")
        bytes_ms = bound_bytes(name, args, got) / HBM_BYTES_PER_S * 1e3
        ops_ms = bound_ops(name, args) / OPS_PER_S * 1e3
        rows[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: getattr(mod, wrapper)(*args), reps, dev),
            plain_ms=time_ms(lambda: getattr(mod, plain)(*args), max(1, reps // 5), dev),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None if lib is None else time_ms(lib, reps, dev),
            shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)])
        print(f"kernel {name}: " + json.dumps(rows[name]), flush=True)
    return rows


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU with the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cpu" if rehearsal else "cuda")
    sz = REHEARSAL if rehearsal else FULL

    # 1. the card
    smi = "" if rehearsal else nvidia_smi()
    kind = "cpu" if rehearsal else torch.cuda.get_device_name(0)
    count = 0 if rehearsal else torch.cuda.device_count()
    print(f"card: {smi} | {kind} | devices {count}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    if not rehearsal:
        t0 = time.perf_counter()
        took = build.build()
        print(f"build: {time.perf_counter() - t0:.1f}s total, per source "
              + json.dumps({k: round(v, 2) for k, v in took.items()}), flush=True)
        for src, log in build.BUILD_LOGS.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {src}: {line.strip()}", flush=True)

    # 3. kernel phase at the main path's shapes
    data = workload(sz, dev, args.seed)
    calls = capture_calls(sz, data, dev)
    krows = kernel_phase(calls, sz["reps"], dev)
    del calls

    # 4. main path: kernels, then plain versions
    runs = {}
    for impl in ("auto", "torch"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        runs[impl] = main_path(impl, sz, data, dev)
        runs[impl]["total_s"] = time.perf_counter() - t0
        runs[impl]["launches"] = build.launch_counts()
        runs[impl]["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else None)
        check_oracle(runs[impl], data, sz)
    same_results(runs["auto"], runs["torch"])
    if not rehearsal:
        check(all(n > 0 for n in runs["auto"]["launches"].values()),
              f"every kernel ran on the main path: {runs['auto']['launches']}")
    check(all(n == 0 for n in runs["torch"]["launches"].values()),
          f"the plain run launched no kernel: {runs['torch']['launches']}")

    n_ins = sz["wave"] * sz["waves"]
    for impl, r in runs.items():
        label = "kernels" if impl == "auto" else "plain"
        print(f"main path ({label}): " + json.dumps(dict(
            insert_keys_per_s=n_ins / sum(r["insert_s"]),
            insert_wave_s=r["insert_s"],
            find_keys_per_s=sz["find"] / r["find_s"],
            find_insert_ops_per_s=2 * sz["fi"] / r["find_insert_s"],
            total_s=r["total_s"], peak_mem_bytes=r["peak_bytes"],
            count_ready=r["count"], launches=r["launches"])), flush=True)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=runs["auto"]["launches"][name],
                    **{k: v for k, v in krows[name].items() if k != "shape"})
               for name, (_m, _w, _p, src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal passed (no device result)")
        return 0
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
