"""Attention: GQA/MQA with qk-norm, sliding windows and KV caches.

The port of ``repro/models/attention.py:116-233``.  Prefill attends
through ``ops.flash_attention``: the hand-written CUDA kernel on the card,
its plain version on the CPU (the JAX package runs the same function as
the XLA ``blockwise_attention`` there; its ``q_block``/``k_block`` are XLA
tiling and mean nothing here).  Decode attends one query against the
cache with a plain matmul, as in JAX (that step is bound by reading the
cache, not by compute).

Caches are updated in place: the prefill writes the cache ``cache_init``
allocated, and each decode step writes its one slot of the same buffers
(the JAX package returns updated copies; here a copy of every layer's
cache per token would cost more than the step).

MLA (``cfg.mla``) and ``cfg.attn_probs_bf16`` wait for ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import normal, rms_norm, rotary

_NEG = -1e30


def decode_attention(q, k, v, kv_len, lo=None):
    """q (B,Hq,1,hd) against cache k/v (B,Hkv,S,hd); kv_len masks unfilled.

    ``lo`` (optional) masks cache slots below it: the sliding-window
    bound when a windowed layer keeps the full-length cache."""
    b, hq, _, hd = q.shape
    _, hkv, s, _ = k.shape
    dv = v.shape[-1]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    logits = torch.einsum("bgrd,bgkd->bgrk", qg, k.float()) * (hd ** -0.5)
    pos = torch.arange(s, device=q.device)
    mask = pos < kv_len
    if lo is not None:
        mask &= pos >= lo
    logits = logits.masked_fill(~mask, _NEG)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrk,bgkd->bgrd", p, v.float())
    return o.reshape(b, hq, 1, dv).to(q.dtype)


def attn_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {
        "wq": normal(gen, (d, nq * hd), s, dtype, device),
        "wk": normal(gen, (d, nkv * hd), s, dtype, device),
        "wv": normal(gen, (d, nkv * hd), s, dtype, device),
        "wo": normal(gen, (nq * hd, d), (nq * hd) ** -0.5, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def attention(params, x, cfg, *, positions, causal=True, window=0, cache=None,
              cache_len=None, impl="auto"):
    """Self-attention block. Returns (out, new_cache | None).

    cache: dict(k (B,Hkv,S,hd), v) for serving.  With T == 1 the step
    appends at ``cache_len`` (or modulo the ring for a window-capped
    cache) and attends over the cache; otherwise it is a prefill that
    attends over x and writes its keys into the cache.
    """
    if cfg.mla is not None or cfg.attn_probs_bf16:
        raise NotImplementedError(
            "MLA and attn_probs_bf16 attention wait for ROADMAP Queue 1 item 6")
    b, t, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    q = (x @ params["wq"]).reshape(b, t, nq, hd).transpose(1, 2)
    k = (x @ params["wk"]).reshape(b, t, nkv, hd).transpose(1, 2)
    v = (x @ params["wv"]).reshape(b, t, nkv, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    q = rotary(q, positions[:, None, :], cfg.rope_theta)
    k = rotary(k, positions[:, None, :], cfg.rope_theta)

    new_cache = None
    if cache is not None and t == 1:
        # decode: append at the absolute position, or modulo the ring
        # size for window-capped caches (cfg.window_cache)
        pos = cache_len
        s_cache = cache["k"].shape[2]
        ring = window > 0 and s_cache <= window
        slot = pos % s_cache if ring else pos
        ck = _cache_append(cache["k"], k, slot)
        cv = _cache_append(cache["v"], v, slot)
        new_cache = {"k": ck, "v": cv}
        kv_len = min(pos + 1, s_cache) if ring else pos + 1
        lo = max(pos + 1 - window, 0) if (window > 0 and not ring) else None
        out = decode_attention(q, ck, cv, kv_len, lo=lo)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
        if cache is not None:   # prefill into the cache
            ck, cv = cache["k"], cache["v"]
            s = ck.shape[2]
            if s < t:
                # window-capped ring: keep the last s keys, stored at
                # row p % s so decode's ring append stays consistent
                shift = (t - s) % s
                ck.copy_(torch.roll(k[:, :, -s:], shift, dims=2))
                cv.copy_(torch.roll(v[:, :, -s:], shift, dims=2))
            else:
                ck[:, :, :t] = k
                cv[:, :, :t] = v
            new_cache = {"k": ck, "v": cv}

    out = out.transpose(1, 2).reshape(b, t, nq * hd)
    return out @ params["wo"], new_cache


def _cache_append(buf, x, pos: int):
    """Write x (B,H,1,hd) at slot ``pos`` of buf (B,H,S,hd), in place."""
    buf[:, :, pos:pos + 1] = x
    return buf
