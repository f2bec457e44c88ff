"""Attention: GQA/MQA with qk-norm, sliding windows, MLA and KV caches.

The port of ``repro/models/attention.py:116-438``.  Prefill attends
through ``ops.flash_attention``: the hand-written CUDA kernel on the card,
its plain version on the CPU (the JAX package runs the same function as
the XLA ``blockwise_attention`` there; its ``q_block``/``k_block`` are XLA
tiling and mean nothing here), with ``cfg.attn_probs_bf16`` passed down.
Decode attends one query against the cache with a plain matmul, as in
JAX (that step is bound by reading the cache, not by compute).

Caches are updated in place: the prefill writes the cache ``cache_init``
allocated, and each decode step writes its one slot of the same buffers
(the JAX package returns updated copies; here a copy of every layer's
cache per token would cost more than the step).

Cross-attention (an encoder-decoder's decoder) is ``attention`` with
``kv_source``, the encoder's output: K and V come from the source, no
rotary is applied, and the flash kernel runs non-causal with ``Tq != Tk``
(the source length).  Given a cache, that call writes the source's K/V
into it (the decoder layer's ``xk``/``xv``), which decode then attends
(``cross_decode``).

MLA (DeepSeek multi-head latent attention) keeps the compressed cache
``c_kv`` (B, S, kv_lora_rank) and a shared-head ``k_rope`` (B, S, rope).
Prefill expands K and V through ``w_ukv`` and attends through the flash
kernel, V zero-padded to the qk head dim (the kernel takes one head dim;
zero columns add nothing, and the output is sliced back).  Decode expands
the whole cache (``mla_absorb`` off) or attends in the latent space
(``mla_absorb``).

Over several model ranks (``bk``, the model axis's backend) each rank
holds its heads' columns of ``wq``/``wk``/``wv`` (MLA: ``w_uq``,
``w_ukv``) and rows of ``wo``, attends its heads, and one ``psum`` after
``wo`` sums the heads' parts; the K/V cache holds this rank's kv heads
(its query group's, where the kv heads are fewer than the ranks).  The
head counts are read from the weights' shapes.  MLA's ``w_dq``, ``w_dkv``,
``w_kr`` and its latent cache are replicated, but for the context-parallel
decode (``mla_cp_decode`` with ``mla_absorb``): the latent cache's
sequence is split over the model ranks, each rank writes the new latent
only where ``pos`` falls in its slice, attends its slice for every head
(the heads' latent queries all-gathered first) and the JAX package's
two-pass combine merges the partials: ``pmax`` of the partial maxima, then
``psum`` of each partial's sum and context rescaled by ``exp(m_i - M)``.
On one rank ``mla_cp_decode`` selects the latent-space decode, where that
combine's ``pmax`` and ``psum`` are identities: the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal, rms_norm, rotary, row_parallel

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
              cache_len=None, kv_source=None, impl="auto", bk=None):
    """Attention block. Returns (out, new_cache | None).

    cache: dict(k (B,Hkv,S,hd), v) for serving.  With T == 1 the step
    appends at ``cache_len`` (or modulo the ring for a window-capped
    cache) and attends over the cache; otherwise it is a prefill that
    attends over x and writes its keys into the cache.
    kv_source (B,S,D): cross-attention over it, rotary on neither side;
    a given cache (the layer's ``xk``/``xv`` as ``k``/``v``) gets the
    source's K/V written into it, whatever T is.
    bk: the model axis's backend; this rank's heads are the weights'.
    """
    b, t, _ = x.shape
    hd = cfg.head_dim
    nq, nkv = params["wq"].shape[1] // hd, params["wk"].shape[1] // hd

    src = x if kv_source is None else kv_source
    ts = src.shape[1]
    q = (x @ params["wq"]).reshape(b, t, nq, hd).transpose(1, 2)
    k = (src @ params["wk"]).reshape(b, ts, nkv, hd).transpose(1, 2)
    v = (src @ params["wv"]).reshape(b, ts, nkv, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if kv_source is None:
        q = rotary(q, positions[:, None, :], cfg.rope_theta)
        k = rotary(k, positions[:, None, :], cfg.rope_theta)

    new_cache = None
    if cache is not None and t == 1 and kv_source is None:
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
        out = ops.flash_attention(q, k, v, causal=causal, window=window, impl=impl,
                                  probs_bf16=cfg.attn_probs_bf16)
        if cache is not None:   # prefill into the cache
            ck, cv = cache["k"], cache["v"]
            s = ck.shape[2]
            if s < ts:
                # window-capped ring: keep the last s keys, stored at
                # row p % s so decode's ring append stays consistent
                shift = (ts - s) % s
                ck.copy_(torch.roll(k[:, :, -s:], shift, dims=2))
                cv.copy_(torch.roll(v[:, :, -s:], shift, dims=2))
            else:
                ck[:, :, :ts] = k
                cv[:, :, :ts] = v
            new_cache = {"k": ck, "v": cv}

    out = out.transpose(1, 2).reshape(b, t, nq * hd)
    return row_parallel(out, params["wo"], bk), new_cache


def cross_decode(params, x, cfg, xk, xv, bk=None):
    """One decode step's cross-attention: x (B,1,D) against the cached
    source K/V (B,Hkv,S,hd) over their full length, with ``q = x @ wq``
    as the JAX package's decode branch computes it
    (``repro/models/lm.py:293-302``: no rotary, no ``q_norm``).  ``bk``:
    the model axis's backend; this rank's heads are the weights', and the
    heads' parts after ``wo`` are summed, as in :func:`attention`."""
    b, hd = x.shape[0], cfg.head_dim
    q = (x @ params["wq"]).reshape(b, 1, -1, hd).transpose(1, 2)
    out = decode_attention(q, xk, xv, xk.shape[2])
    return row_parallel(out.transpose(1, 2).reshape(b, 1, -1), params["wo"], bk)


def _cache_append(buf, x, pos: int):
    """Write x (B,H,1,hd) at slot ``pos`` of buf (B,H,S,hd), in place."""
    buf[:, :, pos:pos + 1] = x
    return buf


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    kvh = m.qk_nope_head_dim + m.v_head_dim
    return {
        "w_dq": normal(gen, (d, m.q_lora_rank), s, dtype, device),
        "w_uq": normal(gen, (m.q_lora_rank, h * qh), m.q_lora_rank ** -0.5, dtype, device),
        "w_dkv": normal(gen, (d, m.kv_lora_rank), s, dtype, device),
        "w_kr": normal(gen, (d, m.qk_rope_head_dim), s, dtype, device),
        "w_ukv": normal(gen, (m.kv_lora_rank, h * kvh), m.kv_lora_rank ** -0.5, dtype, device),
        "wo": normal(gen, (h * m.v_head_dim, d), (h * m.v_head_dim) ** -0.5, dtype, device),
    }


def cp_decode(cfg, bk) -> bool:
    """Whether MLA decodes context-parallel: ``mla_cp_decode`` with
    ``mla_absorb`` over more than one model rank."""
    return cfg.mla_absorb and cfg.mla_cp_decode and bk is not None and bk.nprocs() > 1


def mla_attention(params, x, cfg, *, positions, cache=None, cache_len=None, impl="auto",
                  bk=None):
    """MLA over the compressed (c_kv, k_rope) cache. Returns (out, new_cache | None).

    cache: dict(c_kv (B,S,r), k_rope (B,S,rope)).  With T == 1 the step
    appends at ``cache_len`` and attends over the cache; otherwise it is a
    prefill that attends over x and writes its c_kv and k_rope into the
    cache.  Under :func:`cp_decode` the cache holds this model rank's
    slice of the sequence, ``(B, S/P, .)``."""
    m = cfg.mla
    b, t, _ = x.shape
    nope, rope, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = params["w_uq"].shape[1] // (nope + rope)
    cp = cp_decode(cfg, bk)

    q = ((x @ params["w_dq"]) @ params["w_uq"]).reshape(b, t, h, nope + rope).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rotary(q_rope, positions[:, None, :], cfg.rope_theta)

    c_kv = x @ params["w_dkv"]                          # (B,T,r)
    k_rope = rotary((x @ params["w_kr"])[:, None], positions[:, None, :],
                    cfg.rope_theta)[:, 0]               # (B,T,rope), one shared head

    new_cache = None
    if cache is not None and t == 1:
        pos = cache_len
        c_full, r_full = cache["c_kv"], cache["k_rope"]
        lpos = pos - bk.rank() * c_full.shape[1] if cp else pos
        if 0 <= lpos < c_full.shape[1]:         # under cp: this rank's slice only
            c_full[:, lpos:lpos + 1] = c_kv
            r_full[:, lpos:lpos + 1] = k_rope
        new_cache = {"c_kv": c_full, "k_rope": r_full}
        if cp:
            out = _mla_cp_decode(params, cfg, q_nope, q_rope, c_full, r_full, pos, bk)
            return row_parallel(out, params["wo"], bk), new_cache
        if cfg.mla_absorb:      # mla_cp_decode too on one rank: the same function
            out = _mla_absorbed_decode(params, cfg, q_nope, q_rope, c_full, r_full, pos)
            return row_parallel(out, params["wo"], bk), new_cache
        c_kv, k_rope = c_full, r_full
    elif cache is not None:     # prefill into the cache (under cp: this rank's slice)
        s_loc = cache["c_kv"].shape[1]
        lo = bk.rank() * s_loc if cp else 0
        hi = min(lo + s_loc, t)
        if hi > lo:
            cache["c_kv"][:, :hi - lo] = c_kv[:, lo:hi]
            cache["k_rope"][:, :hi - lo] = k_rope[:, lo:hi]
        new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}

    k, v = _expand_kv(params, cfg, c_kv, k_rope)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    if t == 1 and cache is not None:
        out = decode_attention(q_full, k, v, cache_len + 1)
    else:
        if vdim > nope + rope:
            raise NotImplementedError(f"MLA prefill: v_head_dim {vdim} wider than the qk "
                                      f"head dim {nope + rope}")
        # one head dim for the kernel: V's zero columns add nothing to O
        v = F.pad(v, (0, nope + rope - vdim))
        out = ops.flash_attention(q_full, k, v, causal=True, impl=impl,
                                  probs_bf16=cfg.attn_probs_bf16)[..., :vdim]
    out = out.transpose(1, 2).reshape(b, t, h * vdim)
    return row_parallel(out, params["wo"], bk), new_cache


def _expand_kv(params, cfg, c_kv, k_rope):
    """K (B,H,S,nope+rope) and V (B,H,S,v) of every head of this rank,
    expanded from the compressed c_kv (B,S,r) through ``w_ukv`` in the
    model's dtype, with the shared k_rope (B,S,rope) broadcast over the
    heads."""
    m = cfg.mla
    b, s_len, _ = c_kv.shape
    nope = m.qk_nope_head_dim
    h = params["w_ukv"].shape[1] // (nope + m.v_head_dim)
    kv = (c_kv @ params["w_ukv"]).reshape(b, s_len, h, nope + m.v_head_dim).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s_len, m.qk_rope_head_dim)], dim=-1)
    return k, v


def _absorbed(params, cfg, q_nope, q_rope):
    """The per-head weights split out of ``w_ukv`` and the queries taken
    into the latent space, in float32: (q_lat (B,H,r), q_rope (B,H,rope),
    W_uv (r,H,v), the score scale)."""
    m = cfg.mla
    h, nope = q_nope.shape[1], q_nope.shape[3]
    w_full = params["w_ukv"].reshape(m.kv_lora_rank, h, nope + m.v_head_dim)
    w_uk, w_uv = w_full[:, :, :nope], w_full[:, :, nope:]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0].float(), w_uk.float())
    return (q_lat, q_rope[:, :, 0].float(), w_uv.float(),
            (nope + m.qk_rope_head_dim) ** -0.5)


def _mla_absorbed_decode(params, cfg, q_nope, q_rope, c_kv, k_rope, pos: int):
    """Latent-space MLA decode (weight absorption), the port of
    ``repro/models/attention.py:407-438``.

    q_nope (B,H,1,nope), q_rope (B,H,1,rope); cache c_kv (B,S,r), k_rope
    (B,S,rope) holding slots ``0..pos``.  Scores: q_nope^T (W_uk c) =
    (W_uk^T q_nope)^T c, so the queries are projected down once and the
    cache is used as it is; the context is accumulated in the latent space
    and expanded once.  Returns (B, 1, H*vdim)."""
    q_lat, qr, w_uv, scale = _absorbed(params, cfg, q_nope, q_rope)
    cf = c_kv.float()
    s = torch.einsum("bhr,bsr->bhs", q_lat, cf)
    s = s + torch.einsum("bhp,bsp->bhs", qr, k_rope.float())
    seen = torch.arange(c_kv.shape[1], device=c_kv.device) <= pos
    s = (s * scale).masked_fill(~seen, _NEG)
    ctx = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), cf)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    return out.reshape(q_nope.shape[0], 1, -1).to(q_nope.dtype)


def _cp_combine(bk, m_i, l_i, ctx_i):
    """The two-pass softmax combine of the ranks' partials: ``M = pmax(m_i)``,
    then ``psum`` of ``l_i`` and ``ctx_i`` each rescaled by
    ``exp(m_i - M)``.  m_i, l_i (B,H); ctx_i (B,H,r) -> (B,H,r)."""
    m_g = bk.pmax(m_i)
    w = torch.exp(m_i - m_g)
    l_g = bk.psum(l_i * w)
    ctx = bk.psum(ctx_i * w[..., None])
    return ctx / l_g.clamp(min=1e-30)[..., None]


def _mla_cp_decode(params, cfg, q_nope, q_rope, c_kv, k_rope, pos: int, bk):
    """Context-parallel latent-space MLA decode, the port of
    ``repro/models/attention.py:332-404``: c_kv (B,S/P,r) and k_rope
    (B,S/P,rope) are this model rank's slice of the sequence; q_nope and
    q_rope (B,h,1,.) this rank's heads.  Every head's latent query is
    gathered, each rank attends its slice in float32, :func:`_cp_combine`
    merges the partials, and this rank's heads are expanded through its
    ``W_uv``.  Returns (B, 1, h*vdim)."""
    q_lat, qr, w_uv, scale = _absorbed(params, cfg, q_nope, q_rope)
    b, h, r = q_lat.shape
    rank, s_loc = bk.rank(), c_kv.shape[1]
    q_all = torch.cat(list(bk.all_gather(torch.cat([q_lat, qr], dim=-1))), dim=1)
    cf = c_kv.float()
    s = torch.einsum("bhr,bsr->bhs", q_all[..., :r], cf)
    s = (s + torch.einsum("bhp,bsp->bhs", q_all[..., r:], k_rope.float())) * scale
    seen = rank * s_loc + torch.arange(s_loc, device=c_kv.device) <= pos
    s = s.masked_fill(~seen, _NEG)
    m_i = s.max(dim=-1).values
    e = torch.where(seen, torch.exp(s - m_i[..., None]), 0.0)
    ctx = _cp_combine(bk, m_i, e.sum(dim=-1), torch.einsum("bhs,bsr->bhr", e, cf))
    out = torch.einsum("bhr,rhv->bhv", ctx[:, rank * h:(rank + 1) * h], w_uv)
    return out.reshape(b, 1, -1).to(q_nope.dtype)
