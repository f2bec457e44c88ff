"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base (hf).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.
Dense-MoE hybrid: every layer has a dense residual MLP in parallel with
a 128-expert top-2 MoE (Arctic's architecture).  Expert dispatch runs on
the BCL exchange (models/moe.py) — this arch is a primary carrier of the
paper's technique.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, layer_pattern="g",
    activation="swiglu", rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True, capacity_factor=1.5),
    tie_embeddings=False, fsdp=True,
    optimizer_dtype="bfloat16",
)
