"""seamless-m4t-medium [audio] — arXiv:2308.11596 (hf).

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206; encoder-decoder.
Frontend is a stub per the assignment: input_specs provides precomputed
frame embeddings (B, T/4, D); the speech encoder conv stack is out of
scope (the transformer backbone is what's specified).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, layer_pattern="g",
    encoder_layers=12, frontend="frame",
    activation="gelu", rope_theta=1e4,
    tie_embeddings=False, fsdp=False,
)
