"""Synthetic genomics data for the k-mer / de Bruijn pipeline, PyTorch port.

A copy of ``repro.data.genomics``: :class:`GenomeSim` stays numpy, so a
seed gives the same genome and reads in both packages.  The k-mer
helpers take numpy arrays (numpy results, as in the JAX package) or
torch tensors on any device (int32 word tensors on that device, with
the numpy versions' values).  K-mers pack 2 bits per base into two u32
lanes ``[hi, lo]`` (k <= 31).

:func:`read_kmer_lanes` packs every k-mer of every read with a rolling
2-bit shift in int64, without the ``(M, k)`` base matrix that
``pack_kmers(extract_kmers(...))`` materialises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.u32 import M32, as_u64, to_i32

_BASES = np.array(list("ACGT"))


@dataclasses.dataclass
class GenomeSim:
    genome_len: int = 1 << 16
    read_len: int = 100
    coverage: int = 8
    error_rate: float = 0.01
    seed: int = 0

    def genome(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, 4, self.genome_len).astype(np.uint8)

    def reads(self) -> np.ndarray:
        """(n_reads, read_len) u8 base codes with substitution errors."""
        rng = np.random.default_rng(self.seed + 1)
        g = self.genome()
        n = self.genome_len * self.coverage // self.read_len
        starts = rng.integers(0, self.genome_len - self.read_len, n)
        idx = starts[:, None] + np.arange(self.read_len)[None]
        reads = g[idx]
        errs = rng.random(reads.shape) < self.error_rate
        reads = np.where(errs, (reads + rng.integers(1, 4, reads.shape)) % 4,
                         reads).astype(np.uint8)
        return reads


def _check_k(k: int) -> None:
    if k > 31:
        raise ValueError("k must be <= 31 for 2-lane packing")


def kmer_lanes(values: torch.Tensor) -> torch.Tensor:
    """int64 k-mer values -> (M, 2) int32 words [hi, lo]."""
    return torch.stack([to_i32(values >> 32), to_i32(values & M32)], dim=1)


def kmer_values(lanes: torch.Tensor) -> torch.Tensor:
    """(M, 2) k-mer words [hi, lo] -> their int64 2-bit values."""
    return (as_u64(lanes[:, 0]) << 32) | as_u64(lanes[:, 1])


def extract_kmers(seqs, k: int):
    """(N, L) base codes -> (M, k) all k-mers from every sequence."""
    n, length = seqs.shape
    m = length - k + 1
    if isinstance(seqs, np.ndarray):
        idx = np.arange(m)[:, None] + np.arange(k)[None]
        return seqs[:, idx].reshape(n * m, k)
    return seqs.unfold(1, k, 1).reshape(n * m, k)


def pack_kmers(kmers):
    """(M, k<=31) 2-bit pack into (M, 2) u32 lanes [hi, lo] (the key record)."""
    m, k = kmers.shape
    _check_k(k)
    if isinstance(kmers, np.ndarray):
        val = np.zeros((m,), np.uint64)
        for i in range(k):
            val = (val << np.uint64(2)) | kmers[:, i].astype(np.uint64)
        lo = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (val >> np.uint64(32)).astype(np.uint32)
        return np.stack([hi, lo], axis=1)
    val = torch.zeros(m, dtype=torch.int64, device=kmers.device)
    for i in range(k):
        val = (val << 2) | kmers[:, i].to(torch.int64)
    return kmer_lanes(val)


def read_kmer_lanes(reads, k: int) -> torch.Tensor:
    """``pack_kmers(extract_kmers(reads, k))`` by a rolling 2-bit shift.

    reads (N, L) base codes (a tensor on any device, or numpy); returns
    (N*(L-k+1), 2) int32 words on the reads' device, k-mers of read 0
    first.
    """
    _check_k(k)
    if isinstance(reads, np.ndarray):
        reads = torch.from_numpy(reads)
    n, length = reads.shape
    m = length - k + 1
    b = reads.to(torch.int64)
    val = torch.zeros((n, m), dtype=torch.int64, device=reads.device)
    for i in range(k):
        val = (val << 2) | b[:, i:i + m]
    return kmer_lanes(val.reshape(-1))


def unpack_kmers(lanes: np.ndarray, k: int) -> np.ndarray:
    val = (lanes[:, 0].astype(np.uint64) << np.uint64(32)) | \
        lanes[:, 1].astype(np.uint64)
    out = np.zeros((lanes.shape[0], k), np.uint8)
    for i in range(k - 1, -1, -1):
        out[:, i] = (val & np.uint64(3)).astype(np.uint8)
        val >>= np.uint64(2)
    return out


def kmer_step(lanes: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """The next k-mer of each k-mer when ``base`` (0..3) follows it: the
    walk step of a de Bruijn traversal, on (M, 2) words."""
    mask = (1 << (2 * k)) - 1
    return kmer_lanes(((kmer_values(lanes) << 2) | (base.to(torch.int64) & 3)) & mask)


def kmer_neighbors(lanes, k: int):
    """For contig walking: the 4 possible next k-mers of each k-mer."""
    if isinstance(lanes, np.ndarray):
        val = (lanes[:, 0].astype(np.uint64) << np.uint64(32)) | \
            lanes[:, 1].astype(np.uint64)
        mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
        out = []
        for b in range(4):
            nxt = ((val << np.uint64(2)) | np.uint64(b)) & mask
            out.append(np.stack([(nxt >> np.uint64(32)).astype(np.uint32),
                                 (nxt & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                                axis=1))
        return out
    val = kmer_values(lanes)
    mask = (1 << (2 * k)) - 1
    return [kmer_lanes(((val << 2) | b) & mask) for b in range(4)]
