"""repro_torch: the BCL container library ported to PyTorch and CUDA.

Beside ``repro`` (JAX + Pallas, the reference), with the same layout:

  core/        backends (serial, torch.distributed), hashing, object
               containers, costs, promises, the exchange engine, its
               dense and hierarchical transports, fault injection.
  containers/  the hash map, HashMapBuffer, queues, Bloom filter,
               DArray and heap.
  kernels/     hand-written CUDA kernels for Hopper (csrc/), each with a
               plain PyTorch version beside it, and the impl= dispatcher.
  data/, configs/, models/  the data pipelines, the architectures and
               the LM (serving on one or several ranks, training on one).
  optim/, checkpoint/, runtime/  AdamW and gradient compression,
               checkpoints, fault tolerance and the elastic plan.
  launch/      the serve and train drivers and their step builders.
  interop      state carried across from the JAX package.

Entry points place their state on the card unless the caller asks for
the CPU.  This package imports neither JAX nor ``repro``.
"""

__version__ = "0.1.0"
