"""repro_torch: the BCL container library ported to PyTorch and CUDA.

Beside ``repro`` (JAX + Pallas, the reference), with the same layout:

  core/        backends (serial, torch.distributed), hashing, object
               containers, costs, promises, the exchange engine and its
               dense transport.
  containers/  the distributed hash map.
  kernels/     hand-written CUDA kernels for Hopper (csrc/), each with a
               plain PyTorch version beside it, and the impl= dispatcher.
  interop      state carried across from the JAX package.

Entry points place their state on the card unless the caller asks for
the CPU.  This package imports neither JAX nor ``repro``.
"""

__version__ = "0.1.0"
