"""Kernels of the port, one hand-written CUDA kernel per TPU kernel.

  binning      bin_offsets, pack_rows, place_rows  (csrc/binning.cu)
  hash_probe   insert_arrivals, find_arrivals      (csrc/hash_probe.cu)

Each module keeps a plain PyTorch version beside every kernel; ``ops``
dispatches between them, ``build`` compiles and binds the CUDA sources
at first use, and ``ref`` holds the sequential oracles.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
