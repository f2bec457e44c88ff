"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf).

61L d_model=7168 128H d_ff=2048(expert) vocab=129280.
MLA (q_lora 1536 / kv_lora 512 / rope 64), 1 shared + 256 routed
experts top-8, first 3 layers dense (d_ff 18432), MTP head, aux-free
bias routing.  The technique-representative hillclimb cell: the heaviest
BCL-exchange traffic in the pool.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,  # dense (first_k_dense) layers; experts use expert_d_ff
    vocab=129280, layer_pattern="g",
    activation="swiglu", rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, expert_d_ff=2048,
                  shared_experts=1, first_k_dense=3,
                  bias_update_rate=0.001, capacity_factor=1.3),
    mtp=True,
    tie_embeddings=False, fsdp=True,
    optimizer_dtype="bfloat16", factored_second_moment=True,
)
