"""Quickstart for the PyTorch port: the BCL containers in ten minutes.

Run on a machine with a CUDA card:   PYTHONPATH=src python examples/torch_quickstart.py
Run on the CPU (plain versions):     PYTHONPATH=src python examples/torch_quickstart.py --cpu

The same snippets as examples/quickstart.py, through ``repro_torch``;
it prints the same lines.  On the card the hash map, the queue and the
Bloom filter run through the port's CUDA kernels.
"""

import argparse

import numpy as np
import torch

from repro_torch.containers import bloom as bl
from repro_torch.containers import hashmap as hm
from repro_torch.containers import hashmap_buffer as hb
from repro_torch.containers import queue as q
from repro_torch.core import ConProm, SerialBackend, costs
from repro_torch.core.object_container import Spec


def main(device: str) -> None:
    backend = SerialBackend()
    u32 = Spec((), torch.uint32)

    def words(values):
        return torch.tensor(values, dtype=torch.int64, device=device).to(
            torch.int32).view(torch.uint32)

    # ------------------------------------------------------------ HashMap
    print("== BCL::HashMap ==")
    spec, table = hm.hashmap_create(backend, capacity=4096, key_spec=u32, val_spec=u32,
                                    device=device)
    keys = words(list(range(100)))
    vals = words([k * k for k in range(100)])
    with costs.recording() as log:
        table, ok = hm.insert(backend, spec, table, keys, vals, capacity=128)
    print(f"inserted {int(ok.sum())} pairs, cost per op: "
          f"{log.by_op('hashmap.insert').formula()}")

    table, found_vals, found = hm.find(backend, spec, table, keys, capacity=128,
                                       promise=ConProm.HashMap.find)
    print(f"found {int(found.sum())}, 7^2 = {int(found_vals[7])}")

    # --------------------------------------------------- HashMapBuffer
    print("\n== BCL::HashMapBuffer (paper Fig. 4) ==")
    bspec, buf = hb.create(backend, spec, table, queue_capacity=1024, buffer_cap=512)
    buf, _ = hb.insert(bspec, buf, words([k + 1000 for k in range(100)]),
                       words([k * k + 1 for k in range(100)]))   # local staging only
    buf, dropped = hb.flush(backend, bspec, buf, capacity=512)
    _, v, f = hm.find(backend, spec, buf.map, words([1007]), capacity=4,
                      promise=ConProm.HashMap.find)
    print(f"flushed with {int(dropped)} drops; buffered key 1007 -> {int(v[0])}")

    # ------------------------------------------------------------ Queues
    print("\n== BCL::FastQueue ==")
    qspec, ring = q.queue_create(backend, capacity=256, value_spec=u32, device=device)
    ring, pushed, _ = q.push(backend, qspec, ring, words(list(range(10))),
                             torch.zeros(10, dtype=torch.int32, device=device),
                             capacity=16)
    ring, popped, got = q.local_nonatomic_pop(qspec, ring, 5)
    popped = popped.view(torch.int32).cpu().numpy().astype(np.uint32)
    print(f"pushed {int(pushed)}, popped {popped[got.cpu().numpy()]}")

    # ------------------------------------------------------- BloomFilter
    print("\n== BCL::BloomFilter (blocked, atomic insert) ==")
    fspec, filt = bl.bloom_create(backend, nbits=1 << 16, value_spec=u32, k=4,
                                  device=device)
    filt, already = bl.insert(backend, fspec, filt, words([3, 3, 3, 5, 7]), capacity=8)
    print(f"insert [3,3,3,5,7]: already_present={already.cpu().numpy()} "
          "(exactly one 3 was 'new' — the paper's atomicity invariant)")
    present = bl.find(backend, fspec, filt, words([3, 4]), capacity=4)
    print(f"find [3,4] -> {present.cpu().numpy()}")
    print("\nquickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
    main("cpu" if ap.parse_args().cpu else "cuda")
