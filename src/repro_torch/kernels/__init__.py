"""Kernels of the port, one hand-written CUDA kernel per TPU kernel, two
for the recurrent mixers' scans and one for the attention backward (no
Pallas kernel behind them).

  binning      bin_offsets, pack_rows, place_rows, (csrc/binning.cu)
               ragged_slots, row_mix, histogram
  hash_probe   insert_arrivals, find_arrivals,     (csrc/hash_probe.cu)
               insert, find
  bloom_kernel hash_words, membership              (csrc/bloom.cu)
  flash_attention flash_attention                  (csrc/flash_attention.cu)
               flash_attention_bwd                 (csrc/flash_attention_bwd.cu)
  ssm_scan     mamba_scan, rwkv_scan               (csrc/ssm_scan.cu)

Each module keeps a plain PyTorch version beside every kernel; ``ops``
dispatches between them, ``build`` compiles and binds the CUDA sources
at first use, and ``ref`` holds the sequential oracles.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
