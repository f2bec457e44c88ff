"""Which collectives gloo takes on CUDA tensors, for ranks that share one card.

    python3 scripts/torch_gloo_probe.py [--cpu] [--nprocs 4]

Spawns ``--nprocs`` processes, each a gloo rank over ``tcp://127.0.0.1``,
every one on ``cuda:0`` (or on the CPU with ``--cpu``), and tries
``all_to_all_single``, ``all_gather``, ``all_reduce`` SUM and MAX on
int32, int16, float32 and bfloat16 tensors, each checked against the
result the ranks' inputs define.  Rank 0 prints one JSON line per
(collective, dtype): ``ok``, ``wrong`` or the error's first line, then the
host time of a few calls at the multi-rank serving cells' shapes (every
call ends in a synchronise: gloo's collectives on CUDA tensors go through
host memory).  NCCL takes no two ranks of one communicator on one device,
so these are the only collectives four ranks on one card can run.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = ("int32", "int16", "float32", "bfloat16")
OPS = ("all_to_all_single", "all_gather", "all_reduce_sum", "all_reduce_max")
#: (name, collective, shape, dtype) timed at the cells' shapes
TIMED = (("psum after wo, prefill (8, 2048, 2560)", "all_reduce_sum", (8, 2048, 2560),
          "float32"),
         ("psum after wo, decode (8, 1, 2560)", "all_reduce_sum", (8, 1, 2560), "float32"),
         ("logits all_gather, qwen3-4b (8, 38016)", "all_gather", (8, 38016), "float32"),
         ("MoE wire, deepseek-v3 decode (4 x 36, 3586)", "all_to_all_single", (144, 3586),
          "int32"))


def _input(op: str, dtype, rank: int, n: int, dev, shape=(8, 6)) -> torch.Tensor:
    base = torch.arange(shape[0] * shape[1], device=dev).reshape(shape) % 7 + 1
    return (base * (rank + 1)).to(dtype)


def _expected(op: str, dtype, rank: int, n: int, dev) -> torch.Tensor:
    ins = [_input(op, dtype, r, n, dev) for r in range(n)]
    if op == "all_to_all_single":
        rows = ins[0].shape[0] // n
        return torch.cat([ins[s][rank * rows:(rank + 1) * rows] for s in range(n)])
    if op == "all_gather":
        return torch.stack(ins)
    if op == "all_reduce_sum":
        return sum(i.float() for i in ins).to(dtype)
    return ins[-1]


def _run(op: str, x: torch.Tensor, n: int) -> torch.Tensor:
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.stack(parts)
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "all_reduce_sum" else dist.ReduceOp.MAX)
    return y


def _rank(rank: int, n: int, port: int, cpu: bool) -> None:
    dev = torch.device("cpu" if cpu else "cuda:0")
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank, timeout=timedelta(seconds=60))
    try:
        table = []
        for op in OPS:
            for name in DTYPES:
                dtype = getattr(torch, name)
                x = _input(op, dtype, rank, n, dev)
                try:
                    got = _run(op, x, n)
                    verdict = ("ok" if torch.equal(got, _expected(op, dtype, rank, n, dev))
                               else "wrong")
                except (RuntimeError, ValueError, TypeError) as e:   # the probe's answer
                    verdict = str(e).strip().splitlines()[0][:160]
                dist.barrier()
                table.append({"collective": op, "dtype": name, "device": dev.type,
                              "result": verdict})
        if rank == 0:
            for row in table:
                print("gloo probe: " + json.dumps(row), flush=True)
        ok = {(row["collective"], row["dtype"]) for row in table if row["result"] == "ok"}
        for label, op, shape, name in TIMED:
            if (op, name) not in ok:
                continue
            x = torch.ones(shape, dtype=getattr(torch, name), device=dev)
            ms = []
            for _ in range(4):
                dist.barrier()
                if not cpu:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                _run(op, x, n)
                if not cpu:
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            if rank == 0:
                print("gloo timing: " + json.dumps(
                    {"call": label, "bytes": x.numel() * x.element_size(),
                     "ms": [round(m, 3) for m in ms[1:]]}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nprocs", type=int, default=4)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("gloo probe: no CUDA device (pass --cpu)", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(args.nprocs, port, args.cpu), nprocs=args.nprocs,
                       join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
