"""qwen3-4b [dense] — hf:Qwen/Qwen3 family (hf).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, layer_pattern="g",
    qk_norm=True, head_dim=128,
    activation="swiglu", rope_theta=1e6,
    tie_embeddings=True, fsdp=False,
)
