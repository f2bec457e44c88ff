"""Common layers: norms, rotary embeddings, MLP variants, the dense embedding.

The port of ``repro/models/layers.py:19-65,100-102``, with the JAX
package's dtype order kept so bf16 results agree: statistics in float32,
then cast back before the products.  The vocab-sharded ``embed_lookup``
waits for the port of ``models/sharding.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x (..., T, hd) with positions (..., T); half-split layout."""
    hd = x.shape[-1]
    half = hd // 2
    dev = positions.device
    log_theta = torch.full((), theta, dtype=torch.float32, device=dev).log()  # no host copy
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32, device=dev)
                      / half)
    ang = positions.float()[..., None] * freqs                # (..., T, half)
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def activation_fn(name: str):
    return {
        "gelu": _gelu,
        "relu2": lambda x: torch.square(F.relu(x)),
        "silu": F.silu,
    }.get(name, F.silu)


def mlp(params: dict, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """Gated or plain MLP. params: w_in (D,F), w_out (F,D) [, w_gate (D,F)]."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_in"])
    else:
        h = activation_fn(activation)(x @ params["w_in"])
    return h @ params["w_out"]


def normal(gen: torch.Generator, shape: tuple, scale: float, dtype, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 from ``gen``, then cast (on the
    ``meta`` device, the shape and dtype alone)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def mlp_init(gen: torch.Generator, d: int, f: int, activation: str, dtype,
             device) -> dict:
    p = {
        "w_in": normal(gen, (d, f), d ** -0.5, dtype, device),
        "w_out": normal(gen, (f, d), f ** -0.5, dtype, device),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (d, f), d ** -0.5, dtype, device)
    return p


def embed_lookup_dense(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Single-device lookup."""
    return table[tokens]
