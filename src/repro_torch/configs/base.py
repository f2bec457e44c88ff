"""Architecture configuration schema (a copy of ``repro.configs.base``).

One frozen dataclass drives the whole stack: model assembly
(models/lm.py) and the serving loop.  Every assigned architecture gets
a ``configs/<id>.py`` exporting ``CONFIG`` built from this schema, plus a
``reduced()`` variant for CPU smoke tests.  Fields of the JAX package's
sharding, dry-run and training knobs are kept so the two schemas stay
field for field the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    shared_experts: int = 0          # DeepSeek: always-on shared expert(s)
    dense_residual: bool = False     # Arctic: parallel dense FFN residual
    first_k_dense: int = 0           # DeepSeek: first k layers stay dense
    capacity_factor: float = 1.5     # exchange slot slack
    aux_loss_coef: float = 0.001
    bias_update_rate: float = 0.0    # >0: DeepSeek aux-loss-free bias routing


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64                # Mamba2 state dim / RWKV head dim
    d_conv: int = 4                  # Mamba2 short conv width
    expand: int = 2                  # Mamba2 inner expansion
    n_heads: int = 0                 # 0 => derive from d_model / d_state
    chunk: int = 128                 # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    sliding_window: int = 0          # window for 'l' layers
    layer_pattern: str = "g"         # repeating unit: g=global attn,
                                     # l=local attn, m=mamba2, r=rwkv6,
                                     # a=shared attn (zamba)
    rope_theta: float = 1e4
    activation: str = "swiglu"       # swiglu|geglu|gelu|relu2

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp: bool = False                # DeepSeek multi-token prediction head

    # encoder-decoder (audio) / multimodal (vlm)
    encoder_layers: int = 0          # >0 => enc-dec; decoder = n_layers
    frontend: Optional[str] = None   # None|"frame"|"patch" (stub embeddings)
    frontend_len: int = 256          # patches/frames consumed by the stub

    tie_embeddings: bool = True
    norm_eps: float = 1e-5

    # numerics / memory
    dtype: str = "bfloat16"
    remat: str = "block"             # none|block
    scan_layers: bool = True

    # parallelism hints (see models/sharding.py)
    fsdp: bool = False               # ZeRO-3 over the data axis
    ep_over_model: bool = True       # expert parallelism over model axis
    optimizer_dtype: str = "float32"  # adam moments dtype
    factored_second_moment: bool = False   # adafactor-style v

    # exchange capacity model for MoE dispatch (tokens per (src,dst) pair
    # as a multiple of the uniform expectation)
    moe_capacity_slack: float = 1.5
    # carryover retry rounds for the dispatch exchange: round r re-ships
    # tokens with per-(src,dst) rank in [r*C, (r+1)*C), so hot experts
    # tolerate up to rounds x slack of the uniform load before any token
    # is dropped — skew tolerance without widening every round's wire
    moe_dispatch_rounds: int = 1
    # physical collective layer for the dispatch exchange (DESIGN.md
    # section 1.7): "dense" = one tiled all-to-all over the expert axis,
    # "hier" = two-stage Pr x Pc exchange with sqrt(P) peers per hop
    exchange_transport: str = "dense"

    sub_quadratic: bool = False      # eligible for long_500k

    # ---- perf knobs (EXPERIMENTS.md section Perf) — defaults are the
    # paper-faithful baseline; hillclimbed cells override them ----
    grad_accum: int = 1              # microbatches per step (memory /k)
    remat_policy: str = "default"    # default|nothing|dots
    mla_absorb: bool = False         # DeepSeek weight-absorbed MLA decode
    mla_cp_decode: bool = False      # shard the MLA cache sequence over
                                     # 'model' (context-parallel decode,
                                     # two-pass softmax combine)
    attn_probs_bf16: bool = False    # cast softmax probs to bf16 for PV
    window_cache: bool = False       # cap 'l'-layer decode caches at window
    moe_payload_dtype: str = "float32"   # bfloat16 halves exchange bytes
    moe_dedup_dispatch: bool = False     # one copy per distinct owner rank
    moe_async_dispatch: bool = False     # split-phase dispatch: issue the
                                         # exchange, overlap the always-on
                                         # (shared/dense) paths, then finish
                                         # (DESIGN.md section 1.9)
    attn_q_block: int = 2048
    attn_k_block: int = 1024
    xent_chunk: int = 512

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the embedding shards evenly over any mesh
        axis we use (512 = lcm headroom for model=16 and lane tiling)."""
        return -(-self.vocab // 512) * 512

    @property
    def pattern_unit(self) -> str:
        return self.layer_pattern

    def layer_plan(self) -> tuple[int, str]:
        """(n_full_units, remainder_pattern) for scan-over-layers."""
        u = len(self.layer_pattern)
        return self.n_layers // u, self.layer_pattern[: self.n_layers % u]

    def param_count(self) -> int:
        """Approximate parameter count (for 6*N*D model-flops)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        unit = self.layer_pattern or "g"

        def attn_params():
            if self.mla:
                m = self.mla
                qp = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                kvp = d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
                    m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                op = self.n_heads * m.v_head_dim * d
                return qp + kvp + op
            return d * (n_q + 2 * n_kv) + n_q * d

        def mlp_params(width):
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            return mult * d * width

        def ssm_params():
            inner = (self.ssm.expand if self.ssm else 2) * d
            return d * inner * 2 + inner * d + inner * 64  # rough

        total = 0
        counts = {c: 0 for c in "glmar"}
        for i in range(L):
            counts[unit[i % len(unit)]] += 1
        n_attn = counts["g"] + counts["l"]
        n_ssm = counts["m"] + counts["r"]
        total += n_attn * attn_params()
        if counts["a"]:
            total += attn_params() + counts["a"] * 0  # shared weights
            n_attn += 0
        total += n_ssm * ssm_params()
        if self.moe:
            mo = self.moe
            n_moe = L - mo.first_k_dense
            total += mo.first_k_dense * mlp_params(ff if not self.moe else
                                                   max(ff, 4 * d))
            total += n_moe * (mo.n_experts + mo.shared_experts) * \
                mlp_params(mo.expert_d_ff)
            if mo.dense_residual:
                total += n_moe * mlp_params(ff)
            total += n_moe * d * mo.n_experts  # router
        else:
            total += (n_attn + n_ssm + counts["a"]) * 0
            total += L * mlp_params(ff) if "m" not in unit and "r" not in unit \
                else (counts["g"] + counts["l"] + counts["a"]) * mlp_params(ff)
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn_params() + mlp_params(ff)) \
                + self.n_layers * attn_params()  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared only)."""
        if not self.moe:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        n_moe = self.n_layers - mo.first_k_dense
        all_experts = n_moe * (mo.n_experts + mo.shared_experts) * \
            mult * self.d_model * mo.expert_d_ff
        active_experts = n_moe * (mo.top_k + mo.shared_experts) * \
            mult * self.d_model * mo.expert_d_ff
        return int(full - all_experts + active_experts)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=max(2, len(cfg.layer_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_len=8 if cfg.frontend else 0,
        scan_layers=cfg.scan_layers,
        fsdp=False,
        dtype="float32",
        optimizer_dtype="float32",
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64, first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.mla:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, chunk=16)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
