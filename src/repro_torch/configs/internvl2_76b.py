"""internvl2-76b [vlm] — arXiv:2404.16821 (unverified).

Language backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 (Llama-3-70B-style).  InternViT frontend is a stub per the
assignment: input_specs provides precomputed patch embeddings
(B, 256, D) prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, layer_pattern="g",
    frontend="patch", frontend_len=256,
    activation="swiglu", rope_theta=5e5,
    tie_embeddings=False, fsdp=True,
)
