"""ISx bucket sort, the paper's Figure 3 program, over the PyTorch port.

Run on a machine with a CUDA card:   PYTHONPATH=src python examples/torch_isx_sort.py [n_keys]
Run on the CPU (plain versions):     PYTHONPATH=src python examples/torch_isx_sort.py --cpu [n_keys]

The structure of examples/isx_sort.py: one queue per rank, local
buffers per destination, aggregated pushes once a buffer reaches
MESSAGE_SIZE, barrier, local sort.  On the card each push runs the
exchange's kernels.  It checks its output against ``np.sort`` of the keys.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.containers import queue as q
from repro_torch.core import SerialBackend
from repro_torch.core.object_container import Spec
from repro_torch.core.u32 import M32, as_u64

MESSAGE_SIZE = 4096
KEY_SPACE = 1 << 28


def sort(keys: torch.Tensor):
    """Keys (N,) int32 words below KEY_SPACE -> (sorted int64 values, count)."""
    backend = SerialBackend()       # or a ProcessGroupBackend, one rank each
    nprocs = backend.nprocs()
    n = keys.shape[0]
    spec, queue = q.queue_create(backend, 2 * n, Spec((), torch.uint32), device=keys.device)

    # distribution stage: push each key to its bucket's queue, aggregated
    # into MESSAGE_SIZE chunks
    bucket_width = KEY_SPACE // nprocs
    for i in range(0, n, MESSAGE_SIZE):
        chunk = keys[i:i + MESSAGE_SIZE]
        dest = (chunk // bucket_width).clamp(0, nprocs - 1).to(torch.int32)
        queue, _, _ = q.push(backend, spec, queue, chunk.view(torch.uint32), dest,
                                   capacity=MESSAGE_SIZE)
    backend.barrier()

    # local sort stage (invalid slots sort to the end; sliced off outside)
    rows, got = q.local_drain(spec, queue)
    return torch.sort(torch.where(got, as_u64(rows), M32)).values, got.sum()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_keys", nargs="?", type=int, default=1 << 16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    want = np.random.default_rng(0).integers(0, KEY_SPACE, args.n_keys).astype(np.int32)
    keys = torch.from_numpy(want).to(dev)
    sort(keys)                              # warm-up (the kernels build on first use)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, count = sort(keys)
    out = out[:int(count)].cpu().numpy()    # the host read waits for the device
    dt = time.perf_counter() - t0
    if not np.array_equal(out, np.sort(want)):
        raise SystemExit("isx sort: the output differs from np.sort of the keys")
    print(f"sorted {args.n_keys} keys in {dt*1e3:.1f} ms "
          f"({args.n_keys/dt/1e6:.2f} Mkeys/s) on {dev.type}: verified")


if __name__ == "__main__":
    main()
