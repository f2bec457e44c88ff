"""zamba2-7b [hybrid] — arXiv:2411.15242 (unverified).

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Mamba2 backbone with a SHARED attention block woven in every 6th slot
(one attention parameter set reused — Zamba's signature).  81 = 13 x
"mmmmma" + "mmm" remainder.  Sub-quadratic end-to-end state => runs
long_500k (the shared-attention KV cache is the only seq-len state).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, layer_pattern="mmmmma",
    ssm=SSMConfig(d_state=64, expand=2),
    activation="swiglu",
    tie_embeddings=True, fsdp=True,
    sub_quadratic=True,
)
