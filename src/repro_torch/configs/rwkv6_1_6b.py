"""rwkv6-1.6b [ssm] — Finch, arXiv:2404.05892 (unverified).

24L d_model=2048 d_ff=7168 vocab=65536; attention-free data-dependent
decay linear recurrence.  Sub-quadratic: runs the long_500k shape.
The paper's technique (exchange/containers) is inapplicable to the
mixing layer (no attention, no MoE) — embedding rget only
(DESIGN.md section 6); the arch is built regardless.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, layer_pattern="r",
    ssm=SSMConfig(d_state=64),
    activation="relu2",
    tie_embeddings=False, fsdp=False,
    sub_quadratic=True,
)
