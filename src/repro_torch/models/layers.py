"""Common layers: norms, rotary embeddings, MLP variants, the embeddings.

The port of ``repro/models/layers.py:19-110``, with the JAX package's
dtype order kept so bf16 results agree: statistics in float32, then cast
back before the products.

The vocab-sharded embedding is the BCL DArray remote get served by its
owner: each model rank holds rows ``[r*V/P, (r+1)*V/P)`` of the table,
gathers the rows of the tokens in its range, zeros the rest, and one
``psum`` delivers every row (exact: one addend of each is nonzero).  The
head multiplies by the rank's rows and all-gathers the logits, so every
rank picks the same greedy token.  A product whose weight rows are split
over the model ranks (:func:`row_parallel`: attention's ``wo``, the MLP's
``w_out``) keeps each rank's partial in float32 and rounds once after the
sum, as the one-rank product rounds once.  A norm over a width whose
columns are split over the model ranks (:func:`rms_norm_split`: Mamba2's
gated norm, RWKV-6's ``ln_x``) sums the float32 squares with one ``psum``
and divides by the whole width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def mlp(params: dict, x: torch.Tensor, activation: str = "swiglu", bk=None) -> torch.Tensor:
    """Gated or plain MLP. params: w_in (D,F), w_out (F,D) [, w_gate (D,F)];
    with ``bk``, the model axis's backend, this rank's F/P of the hidden
    width, the ranks' outputs summed."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_in"])
    else:
        h = activation_fn(activation)(x @ params["w_in"])
    return row_parallel(h, params["w_out"], bk)


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
    """Single-device lookup (``F.embedding``: its gradient sums each row's
    tokens in a fixed order on the card, so a training step repeats bit
    for bit)."""
    return F.embedding(tokens, table)


def row_parallel(x: torch.Tensor, w_loc: torch.Tensor, bk) -> torch.Tensor:
    """``x @ w`` where ``w_loc`` holds this model rank's rows of ``w`` and
    ``x`` the matching columns: the ranks' partial products summed.  Each
    partial is kept in float32 and the sum is rounded once to ``x``'s
    dtype, as the one-rank product rounds once; rounding each partial
    first put the ranks' bf16 first layer 9.2e-3 from the one-rank one on
    an H100.  On the card a bf16 partial comes from cuBLAS's bf16-in,
    float32-out product, at the bf16 rate and with no float32 copy of
    the weight; on the CPU the operands are upcast."""
    if bk is None or bk.nprocs() == 1:
        return x @ w_loc
    if x.dtype == torch.float32:
        part = x @ w_loc
    elif x.is_cuda:
        part = torch.mm(x.reshape(-1, x.shape[-1]), w_loc,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], w_loc.shape[-1])
    else:
        part = x.float() @ w_loc.float()
    return bk.psum(part).to(x.dtype)


def rms_norm_split(x: torch.Tensor, gamma_loc: torch.Tensor, eps: float, bk) -> torch.Tensor:
    """``rms_norm`` of the whole width when ``x`` holds this model rank's
    columns of it and ``gamma_loc`` the matching gains: each rank's float32
    sum of squares summed by one ``psum`` over ``bk``, then divided by the
    whole width (every rank's columns count alike)."""
    if bk is None or bk.nprocs() == 1:
        return rms_norm(x, gamma_loc, eps)
    ss = bk.psum(x.float().square().sum(dim=-1, keepdim=True))
    var = ss / (x.shape[-1] * bk.nprocs())
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma_loc


def embed_lookup(table_loc: torch.Tensor, tokens: torch.Tensor, bk) -> torch.Tensor:
    """Rows of ``tokens`` (B, T) from the vocab shard ``table_loc``
    (V/P, D) this model rank of ``bk`` holds: owner-computes remote get
    with one ``psum`` in the table's dtype (exact: one addend of each
    element is nonzero)."""
    if bk is None or bk.nprocs() == 1:
        return embed_lookup_dense(table_loc, tokens)
    vloc = table_loc.shape[0]
    loc = tokens.long() - bk.rank() * vloc
    hit = (loc >= 0) & (loc < vloc)
    return bk.psum(torch.where(hit[..., None], table_loc[loc.clamp(0, vloc - 1)], 0))


def output_logits(x: torch.Tensor, table_loc: torch.Tensor, bk) -> torch.Tensor:
    """``x (..., D) @ table.T`` over the whole vocab: this rank's rows'
    logits, all-gathered over ``bk`` in rank order."""
    logits = x @ table_loc.T
    if bk is None or bk.nprocs() == 1:
        return logits
    parts = bk.all_gather(logits)                      # (P, ..., V/P)
    return torch.cat(list(parts), dim=-1)


def _chunk_nll(xc: torch.Tensor, table: torch.Tensor, yc: torch.Tensor, mc: torch.Tensor,
               vocab_real: int) -> torch.Tensor:
    """One chunk's masked NLL sum: float32 logits (the product in the
    table's dtype, then upcast, as JAX's einsum + astype), the padded vocab
    at -1e30, logsumexp minus the picked logit."""
    logits = (xc @ table.T).float()
    if vocab_real < table.shape[0]:
        logits[..., vocab_real:] = -1e30
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, yc[..., None].long())[..., 0]
    return ((lse - picked) * mc).sum()


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, chunk: int = 512,
                         vocab_real: int | None = None) -> torch.Tensor:
    """Cross-entropy of ``x (B, T, D)`` against the head ``table (V, D)`` over
    chunks of T, divided by ``max(mask.sum(), 1)`` (the port of
    ``repro/models/layers.py:113-141``; T splits into chunks of ``chunk``
    when it divides, else one chunk).  Under autograd each chunk runs in
    ``torch.utils.checkpoint``, so only one chunk's (B, chunk, V) float32
    logits live at a time, in the forward and in the backward.
    ``vocab_real`` masks padding rows of the table out of the normalizer."""
    b, t, _ = x.shape
    n = t // chunk if t % chunk == 0 else 1
    c = t // n
    vreal = vocab_real or table.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], table, targets[:, sl], mask[:, sl].float(), vreal)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total / mask.sum().clamp(min=1)
