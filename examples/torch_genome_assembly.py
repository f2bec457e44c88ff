"""Meraculous-style genome assembly over the PyTorch port: k-mer counting
+ contig generation.

Run on a machine with a CUDA card:   PYTHONPATH=src python examples/torch_genome_assembly.py
Run on the CPU (plain versions):     PYTHONPATH=src python examples/torch_genome_assembly.py --cpu

The pipeline of examples/genome_assembly.py (paper section 9.2), with
the reads and k-mers on the device:
  1. simulate a genome + error-prone reads
  2. count k-mers with the Bloom-filter pre-pass (singletons, mostly
     sequencing errors, never enter the hash table)
  3. keep solid k-mers (count >= 2), build the de Bruijn table
     k-mer -> next-base through a HashMapBuffer
  4. walk contigs with phase-local finds (ConProm find-only)
It checks that the contig it walked occurs in the simulated genome.
"""

import argparse

import torch

from repro_torch.containers import bloom as bl
from repro_torch.containers import hashmap as hm
from repro_torch.containers import hashmap_buffer as hb
from repro_torch.core import ConProm, SerialBackend
from repro_torch.core.object_container import Spec
from repro_torch.data import genomics as gen
from repro_torch.kernels.ops import MODE_ADD

K = 17
BASES = "ACGT"
U32 = Spec((), torch.uint32)


def _record(lanes: torch.Tensor) -> dict:
    """(M, 2) k-mer words -> the ``{"hi", "lo"}`` key record."""
    return {"hi": lanes[:, 0], "lo": lanes[:, 1]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-len", type=int, default=1 << 12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    backend = SerialBackend()
    sim = gen.GenomeSim(genome_len=args.genome_len, coverage=12, error_rate=0.005, seed=7)
    reads = torch.from_numpy(sim.reads()).to(dev)
    print(f"genome {sim.genome_len}bp, {reads.shape[0]} reads of "
          f"{sim.read_len}bp, {sim.error_rate:.1%} error rate")

    # ---- stage 1: k-mer counting with Bloom pre-pass ----
    kmers = gen.read_kmer_lanes(reads, K)
    n = kmers.shape[0]
    kspec = {"hi": U32, "lo": U32}
    items = _record(kmers)

    bspec, filt = bl.bloom_create(backend, 1 << 22, kspec, k=4, device=dev)
    filt, seen_before = bl.insert(backend, bspec, filt, items, capacity=n)

    cspec, counts = hm.hashmap_create(backend, 1 << 17, kspec, U32, block_size=64,
                                      device=dev)
    counts, _ = hm.insert(backend, cspec, counts, items,
                          torch.ones(n, dtype=torch.int32, device=dev), capacity=n,
                          valid=seen_before, mode=MODE_ADD, attempts=3)
    stored = int(hm.count_ready(backend, counts))
    print(f"{n} k-mers, {stored} entered the table "
          f"(Bloom filtered {1 - stored / n:.0%} as probable singletons)")

    # ---- stage 2: solid extensions -> de Bruijn table (buffered build) ----
    # like the paper's pipeline, only extensions observed >=2 times enter
    # the graph (single-occurrence (k+1)-mers are presumed read errors)
    uniq, cnt = torch.unique(gen.kmer_values(kmers), return_counts=True)
    e_uniq, e_cnt = torch.unique(gen.kmer_values(gen.read_kmer_lanes(reads, K + 1)),
                                 return_counts=True)
    e_solid = e_uniq[e_cnt >= 2]             # (k+1)-mers give extensions
    ext = gen.kmer_lanes(e_solid >> 2)
    nxt = (e_solid & 3).to(torch.int32)

    dspec, table = hm.hashmap_create(backend, 1 << 17, kspec, U32, block_size=64,
                                     device=dev)
    bufspec, buf = hb.create(backend, dspec, table, queue_capacity=2 * len(ext),
                             buffer_cap=2 * len(ext))
    buf, _ = hb.insert(bufspec, buf, _record(ext), nxt)
    buf, dropped = hb.flush(backend, bufspec, buf, capacity=2 * len(ext))
    table = buf.map
    print(f"de Bruijn table: {len(ext)} solid extensions via "
          f"HashMapBuffer ({int(dropped)} drops)")

    # ---- stage 3: contig walk (find-only phase) ----
    cur = gen.kmer_lanes(uniq[cnt >= 3][:1])
    contig = []
    for _ in range(2000):
        table, v, found = hm.find(backend, dspec, table, _record(cur), capacity=4,
                                  promise=ConProm.HashMap.find, attempts=3)
        if not bool(found[0]):
            break
        b = int(v.view(torch.int32)[0]) & 3
        contig.append(b)
        cur = gen.kmer_step(cur, torch.full((1,), b, device=dev), K)
    contig_str = "".join(BASES[b] for b in contig[:60])
    print(f"walked a contig of {len(contig)} bases: {contig_str}...")

    # verify the contig appears in the true genome
    gs = "".join(BASES[b] for b in sim.genome())
    ok = contig_str in gs
    print(f"contig matches reference genome: {ok}")
    if not ok:
        raise SystemExit("genome assembly: the contig is not in the simulated genome")


if __name__ == "__main__":
    main()
