"""gemma3-4b [dense] — hf:google/gemma-3-*-pt family (unverified).

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5 local(sliding-1024):1 global layer pattern; 128k-ready rope base.
34 = 5x"lllllg" + "llll" remainder (the assembler unrolls the tail).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, layer_pattern="lllllg",
    sliding_window=1024, qk_norm=True,
    activation="geglu", rope_theta=1e6,
    tie_embeddings=True, fsdp=False,
)
