"""Model assembly: the decoder-only and encoder-decoder LMs and their serving path.

The port of ``repro/models/lm.py`` for the layer kinds ``g`` (global
attention), ``l`` (sliding-window attention), ``m`` (Mamba2), ``r``
(RWKV-6 with its channel mix) and ``a`` (Zamba's shared attention block),
GQA or MLA, dense or MoE (``models/moe.py``, after the ``first_k_dense``
prefix), decoder-only or encoder-decoder, with the ``patch`` and ``frame``
frontends' precomputed embeddings as inputs: ``init_params``,
``abstract_params`` and the two exact parameter counts, ``cache_init``,
``encode``, ``forward``, ``prefill`` and ``decode_step``, with the JAX
package's quirks kept (the ``sqrt(d_model)`` embedding scale taken in the
model's dtype, the padded vocab rows masked to ``-1e30``, the cache's
``pos`` bookkeeping).

Parameters are a dict: ``embed`` (padded_vocab, D), ``final_norm``,
``lm_head`` when the embeddings are untied, and ``layers``, one dict per
layer in order (an attention layer's ``ln1``, ``attn``, ``ln2``, and
``mlp`` or ``moe``; an ``m`` layer's ``ln1`` and ``mamba``; an ``r``
layer's ``ln1``, ``rwkv``, ``ln2`` and ``cmix``; an ``a`` layer's unused
``ln1`` and the float32 ``use_shared`` marker, as in JAX).  With an ``a``
kind in the pattern, ``shared_attn`` (``ln1``, ``attn``, ``ln2``, ``mlp``)
is the one parameter set every ``a`` layer runs.  The JAX package stacks
its repeating units on a leading axis for ``scan``;
``repro_torch.interop.lm_params_from_numpy`` unstacks them.  The layer
loop is a Python loop (no scan; remat in training, below).  An MLA layer's cache is
``{c_kv, k_rope}``; an ``m`` layer's ``{conv, ssd}`` (both float32), an
``r`` layer's ``{s, prev, cm_prev}``, an ``a`` layer's own K/V.  With
``cfg.mtp`` the parameters carry the MTP head
(``mtp_block``, ``mtp_norm``, ``mtp_proj``); as in the JAX package only
``loss_fn`` applies it, so serving carries it unused.

An encoder-decoder model (``cfg.encoder_layers``) has ``encoder``, a list
of ``g`` blocks, and ``enc_norm``; each decoder attention layer adds
``ln_x`` and ``xattn``, and its cache ``xk``/``xv`` (B, Hkv, S_src, hd).
``encode`` runs the source (``src_embeds``, the ``frame`` frontend's
output) bidirectionally with rotary over source positions.  The prefill
cross-attends the encoder's output and writes its K/V into ``xk``/``xv``;
decode attends them.  The JAX package's prefill never writes them, so
its decode stops cross-attending after the first token (ROADMAP Queue 3);
the port computes what its decode branch defines.  ``patch_embeds`` (the
``patch`` frontend's output) go before the scaled token embeddings, cast
to the model's dtype, and positions run over patches and text;
``loss_fn`` drops the patch positions (JAX's ``n_skip``) before the loss.

Training (``loss_fn``, the port of ``repro/models/lm.py:464-503``) runs on
one rank for the kinds ``g``, ``l`` and ``a``, GQA or MLA, dense MLPs or
MoE layers (their gradients carried back over the exchange's wire:
``models/moe.py``), ``attn_probs_bf16``, decoder-only with
``patch_embeds`` and the encoder-decoder with ``src_embeds``, with the
MTP head where ``cfg.mtp`` asks for it.  Under autograd with
``cfg.remat == "block"`` the forward recomputes each layer (and each
encoder block) in the backward (``torch.utils.checkpoint``,
non-reentrant), as JAX's ``jax.checkpoint`` of its scanned unit does,
with the cost log muted while it recomputes (JAX records once, at trace
time); ``remat_policy="dots"`` keeps the outputs of the unbatched matmuls
(``torch.mm``: the projections and MLPs), as JAX's
``dots_with_no_batch_dims_saveable``.  The results are the same either
way.  The kinds ``m`` and ``r`` (item 7c) and a layout of several ranks
(item 7d) are refused with ``NotImplementedError``.

Over several ranks (``layout``, a :class:`~repro_torch.models.sharding.Layout`;
None is one rank): each data rank serves its own batch rows; over the
model axis each rank holds its slice of every parameter
(``sharding.shard_params``; ``init_params`` draws the one-rank sequence
and keeps only the slice), the embedding is the vocab-sharded lookup,
attention (the shared ``a`` block's, the encoder's and the cross-attention
included) and the MLPs are tensor-parallel with one ``psum`` each, MoE
layers dispatch over the model axis, Mamba2 and RWKV-6 run the rank's
heads (``models/ssm.py``), the head's logits are all-gathered, and each
rank's cache holds its kv heads (``xk``/``xv`` too), its heads of the
recurrent state (or, for the context-parallel MLA decode, its slice of the
sequence).  ``patch_embeds`` and ``src_embeds`` are replicated inputs.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costs
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the layer kinds the port runs
KINDS = "glmra"


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a layer kind outside the JAX package's zoo
    (every architecture of the registry runs)."""
    unknown = set(cfg.layer_pattern) - set(KINDS)
    if unknown:
        raise ValueError(f"{cfg.name}: layer kinds {sorted(unknown)} are not among {KINDS!r}")


def kind_at(cfg: ArchConfig, layer_idx: int) -> str:
    pat = cfg.layer_pattern
    return pat[layer_idx % len(pat)]


def _layer_is_moe(cfg: ArchConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _block_init(gen, cfg, dtype, device, kind: str, moe_layer: bool,
                cross: bool = False, experts: slice | None = None) -> dict:
    d = cfg.d_model
    p = {"ln1": torch.ones(d, dtype=dtype, device=device)}
    if kind in ("g", "l"):
        init = attn_mod.mla_init if cfg.mla is not None else attn_mod.attn_init
        p["attn"] = init(gen, cfg, dtype, device)
        p["ln2"] = torch.ones(d, dtype=dtype, device=device)
        if moe_layer:
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, experts)
        else:
            p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype, device)
        if cross:
            p["ln_x"] = torch.ones(d, dtype=dtype, device=device)
            p["xattn"] = attn_mod.attn_init(gen, cfg, dtype, device)
    elif kind == "m":
        p["mamba"] = ssm_mod.mamba_init(gen, cfg, dtype, device)
    elif kind == "r":
        p["rwkv"] = ssm_mod.rwkv_init(gen, cfg, dtype, device)
        p["ln2"] = torch.ones(d, dtype=dtype, device=device)
        p["cmix"] = ssm_mod.rwkv_channel_mix_init(gen, cfg, dtype, device)
    else:                                          # "a": the shared block's marker
        p["use_shared"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device, layout=None) -> dict:
    """Random parameters from ``gen`` (a generator on ``device``; on the
    ``meta`` device, shapes and dtypes only, and ``gen`` may be None).

    The same shapes, scales and dtypes as the JAX package's
    ``init_params``; the draws differ (carry JAX parameters across with
    ``interop.lm_params_from_numpy``).  With a ``layout`` of several model
    ranks the same sequence is drawn and each piece is cut to this rank's
    slice as it is drawn (a MoE layer expert by expert), so the ranks'
    slices are the one-rank parameters bit for bit and no rank holds the
    whole tree."""
    check_supported(cfg)
    sharding.check_layout(cfg, layout)
    lay = sharding.of(layout)
    e_loc = cfg.moe.n_experts // lay.model if cfg.moe else 0
    experts = slice(lay.model_rank * e_loc, (lay.model_rank + 1) * e_loc)

    def mine(tree, *path):
        return sharding.shard_params(tree, cfg, layout, path)

    def layer(i):
        bp = _block_init(gen, cfg, dtype, device, kind_at(cfg, i), _layer_is_moe(cfg, i),
                         cross, experts)
        drawn = bp["moe"].pop("experts") if "moe" in bp else None   # this rank's already
        bp = mine(bp, "layers", i)
        if drawn is not None:
            bp["moe"]["experts"] = drawn
        return bp
    dtype = dtype_of(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {"embed": mine(L.normal(gen, (v, d), d ** -0.5, dtype, device), "embed"),
              "final_norm": torch.ones(d, dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mine(L.normal(gen, (v, d), d ** -0.5, dtype, device), "lm_head")
    cross = cfg.encoder_layers > 0
    params["layers"] = [layer(i) for i in range(cfg.n_layers)]
    if "a" in cfg.layer_pattern:
        params["shared_attn"] = {
            "ln1": torch.ones(d, dtype=dtype, device=device),
            "attn": mine(attn_mod.attn_init(gen, cfg, dtype, device), "shared_attn", "attn"),
            "ln2": torch.ones(d, dtype=dtype, device=device),
            "mlp": mine(L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype, device),
                        "shared_attn", "mlp")}
    if cross:
        params["encoder"] = [mine(_block_init(gen, cfg, dtype, device, "g", False), "encoder", j)
                             for j in range(cfg.encoder_layers)]
        params["enc_norm"] = torch.ones(d, dtype=dtype, device=device)
    if cfg.mtp:
        params["mtp_block"] = mine(_block_init(gen, cfg, dtype, device, "g", False),
                                   "mtp_block")
        params["mtp_norm"] = torch.ones(d, dtype=dtype, device=device)
        params["mtp_proj"] = L.normal(gen, (2 * d, d), (2 * d) ** -0.5, dtype, device)
    return params


def abstract_params(cfg: ArchConfig, layout=None) -> dict:
    """The parameters' shapes and dtypes without allocation: ``init_params``
    on the ``meta`` device (this rank's, with a ``layout``)."""
    return init_params(cfg, None, torch.device("meta"), layout)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def param_count_exact(cfg: ArchConfig) -> int:
    return sum(t.numel() for _, t in _leaves(abstract_params(cfg)))


def active_param_count_exact(cfg: ArchConfig) -> int:
    """Active per-token params: non-expert params + top_k+shared experts."""
    leaves = list(_leaves(abstract_params(cfg)))
    total = sum(t.numel() for _, t in leaves)
    if not cfg.moe:
        return total
    expert_total = sum(t.numel() for path, t in leaves if "experts" in path)
    mo = cfg.moe
    return int(total - expert_total * (1 - mo.top_k / mo.n_experts))


def cache_init(cfg: ArchConfig, batch: int, cache_len: int, device,
               cross_len: int = 0, layout=None) -> dict:
    """Zeroed caches, one per layer: K/V (an ``a`` layer's too), with
    ``window_cache`` capping an ``l`` layer's at the window (a ring); an
    MLA layer's ``c_kv`` and ``k_rope``; an ``m`` layer's float32 ``conv``
    and ``ssd``; an ``r`` layer's float32 ``s`` and its ``prev`` and
    ``cm_prev`` in the model's dtype.  An encoder-decoder's ``g``/``l``
    layers also get the cross K/V ``xk``/``xv`` of ``cross_len`` source
    positions.  With a ``layout``: this model rank's kv heads (``xk``/``xv``
    too) and heads of ``ssd`` and ``s`` (as JAX's ``cache_shardings``
    splits them, ``repro/launch/steps.py:136-147``), and under the
    context-parallel MLA decode its ``cache_len / P`` positions."""
    check_supported(cfg)
    sharding.check_layout(cfg, layout)
    lay = sharding.of(layout)
    dtype = dtype_of(cfg)
    hd = cfg.head_dim
    nkv = (cfg.n_kv_heads // lay.model
           if sharding.kv_split(cfg, lay.model) == "split" else 1) \
        if lay.model > 1 else cfg.n_kv_heads
    s_mla = cache_len
    if attn_mod.cp_decode(cfg, lay.model_bk):
        if cache_len % lay.model:
            raise ValueError(f"{cfg.name}: the context-parallel MLA cache of {cache_len} "
                             f"positions does not split over {lay.model} model ranks")
        s_mla = cache_len // lay.model
    layers = []
    for i in range(cfg.n_layers):
        kind = kind_at(cfg, i)
        if kind == "m":
            layers.append(ssm_mod.mamba_state_init(cfg, batch, device, model=lay.model))
            continue
        if kind == "r":
            layers.append(dict(ssm_mod.rwkv_state_init(cfg, batch, device, dtype, model=lay.model),
                               cm_prev=torch.zeros((batch, cfg.d_model), dtype=dtype,
                                                   device=device)))
            continue
        if cfg.mla is not None and kind != "a":
            m = cfg.mla
            c = {"c_kv": torch.zeros((batch, s_mla, m.kv_lora_rank), dtype=dtype,
                                     device=device),
                 "k_rope": torch.zeros((batch, s_mla, m.qk_rope_head_dim), dtype=dtype,
                                       device=device)}
        else:
            s_len = cache_len
            if (cfg.window_cache and kind == "l" and cfg.sliding_window
                    and cfg.sliding_window < cache_len):
                s_len = cfg.sliding_window
            c = {n: torch.zeros((batch, nkv, s_len, hd), dtype=dtype, device=device)
                 for n in ("k", "v")}
        if cfg.encoder_layers and kind != "a":
            c.update({n: torch.zeros((batch, nkv, cross_len, hd), dtype=dtype, device=device)
                      for n in ("xk", "xv")})
        layers.append(c)
    return {"pos": 0, "layers": layers}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(bp, x, cfg, kind: str, *, positions, shared_params=None, enc_out=None,
                 cache=None, cache_len=None, impl="auto", layout=None, aux=None):
    """Pre-norm block. Returns (x, new_cache); a MoE layer appends its
    load-balance loss to ``aux`` if a list is given."""
    bk = None if layout is None else layout.model_bk
    if kind == "m":
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        o, new_cache = ssm_mod.mamba_apply(bp["mamba"], h, cfg, cache, impl=impl, bk=bk)
        return x + o, new_cache
    if kind == "r":
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        st = {k: cache[k] for k in ("s", "prev")} if cache is not None else None
        o, new_cache = ssm_mod.rwkv_apply(bp["rwkv"], h, cfg, st, impl=impl, bk=bk)
        x = x + o
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        o, new_cache["cm_prev"] = ssm_mod.rwkv_channel_mix(
            bp["cmix"], h, cache["cm_prev"] if cache is not None else None, bk=bk)
        return x + o, new_cache
    if kind == "a":
        bp = shared_params
    window = cfg.sliding_window if kind == "l" else 0
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    sub_cache = None
    if cache is not None:
        sub_cache = {k: v for k, v in cache.items() if k not in ("xk", "xv")}
    if cfg.mla is not None and kind != "a":
        o, new_cache = attn_mod.mla_attention(bp["attn"], h, cfg, positions=positions,
                                              cache=sub_cache, cache_len=cache_len, impl=impl,
                                              bk=bk)
    else:
        o, new_cache = attn_mod.attention(bp["attn"], h, cfg, positions=positions,
                                          causal=True, window=window, cache=sub_cache,
                                          cache_len=cache_len, impl=impl, bk=bk)
    x = x + o
    if "xattn" in bp and enc_out is not None:
        # cross-attention over the encoder's output; the prefill keeps its K/V
        h = L.rms_norm(x, bp["ln_x"], cfg.norm_eps)
        x_cache = None if cache is None else {"k": cache["xk"], "v": cache["xv"]}
        xo, xc = attn_mod.attention(bp["xattn"], h, cfg, positions=positions, causal=False,
                                    cache=x_cache, kv_source=enc_out, impl=impl, bk=bk)
        x = x + xo
        if xc is not None:
            new_cache.update(xk=xc["k"], xv=xc["v"])
    elif "xattn" in bp and cache is not None:
        # decode: attend the cross K/V the prefill wrote
        h = L.rms_norm(x, bp["ln_x"], cfg.norm_eps)
        x = x + attn_mod.cross_decode(bp["xattn"], h, cfg, cache["xk"], cache["xv"], bk=bk)
        new_cache.update(xk=cache["xk"], xv=cache["xv"])
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        # expert_load and the wire drops ride the dispatch; serving reads neither
        y, aux_l, _stats = moe_mod.moe_apply(bp["moe"], h, cfg, layout, impl=impl)
        if aux is not None:
            aux.append(aux_l)
    else:
        y = L.mlp(bp["mlp"], h, cfg.activation, bk)
    return x + y, new_cache


def encode(params, cfg: ArchConfig, src_embeds, *, impl: str = "auto", layout=None):
    """The bidirectional encoder over precomputed frontend embeddings
    (B, S, D): ``g`` blocks without a cache, non-causal self-attention with
    rotary over source positions, then ``enc_norm``.  ``layout``: the
    ranks (None: one); ``params`` are this rank's."""
    bk = None if layout is None else layout.model_bk
    x = src_embeds.to(dtype_of(cfg))
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    remat = _remat(cfg, params["enc_norm"])
    for bp in params["encoder"]:
        block = functools.partial(_encoder_block, bp, cfg=cfg, positions=positions, impl=impl,
                                  bk=bk)
        x = block(x) if remat is None else remat(block, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _save_unbatched_matmuls(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep ``torch.mm`` outputs, recompute the rest."""
    keep = op is torch.ops.aten.mm.default
    return (ckpt.CheckpointPolicy.MUST_SAVE if keep
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, param: torch.Tensor):
    """The per-layer recompute of ``cfg.remat == "block"`` when autograd
    records the parameters (``param`` one of them), as a callable
    ``(fn, *args)``; None when nothing is recomputed (serving)."""
    if cfg.remat != "block" or not ops.needs_grad(param):
        return None
    dots = cfg.remat_policy == "dots"

    def ctx_fn():
        fwd, rec = (ckpt.create_selective_checkpoint_contexts(_save_unbatched_matmuls) if dots
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _muted(rec)
    return functools.partial(ckpt.checkpoint, use_reentrant=False, context_fn=ctx_fn)


@contextlib.contextmanager
def _muted(ctx):
    """``ctx``, with the cost log muted: the recompute records nothing."""
    with ctx, costs.muted():
        yield


def _encoder_block(bp, x, cfg, *, positions, impl="auto", bk=None):
    """One pre-norm encoder block: non-causal self-attention, then the MLP."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    o, _ = attn_mod.attention(bp["attn"], h, cfg, positions=positions, causal=False,
                              impl=impl, bk=bk)
    x = x + o
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, cfg.activation, bk)


def forward(params, cfg: ArchConfig, tokens, *, patch_embeds=None, src_embeds=None,
            cache=None, decode: bool = False, impl: str = "auto", layout=None, aux=None):
    """Returns (hidden (B,T,D), new_cache | None).  ``patch_embeds`` (B,P,D)
    go before the tokens (T counts them); ``src_embeds`` (B,S,D) are encoded
    once and cross-attended by an encoder-decoder's decoder.  ``layout``:
    the ranks (None: one); ``params`` and ``cache`` are this rank's.
    ``aux``, a list, gets each MoE layer's load-balance loss.  Without a
    cache and under autograd, ``cfg.remat == "block"`` recomputes each
    layer in the backward."""
    check_supported(cfg)
    sharding.check_layout(cfg, layout)
    b, t = tokens.shape
    dtype = dtype_of(cfg)
    dev = tokens.device

    x = L.embed_lookup(params["embed"], tokens, None if layout is None else layout.model_bk)
    # the scale is rounded to the model's dtype first, as in JAX
    x = (x * torch.full((), cfg.d_model ** 0.5, dtype=dtype, device=dev)).to(dtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(dtype), x], dim=1)
        t = x.shape[1]

    enc_out = None
    if cfg.encoder_layers and src_embeds is not None:
        enc_out = encode(params, cfg, src_embeds, impl=impl, layout=layout)
    elif cfg.encoder_layers and cache is not None and not decode:
        # the JAX package fails here too (its decode branch meets T > 1)
        raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs src_embeds")

    if decode:
        positions = torch.full((b, 1), cache["pos"], dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    cache_len = cache["pos"] if cache is not None else None

    remat = _remat(cfg, params["final_norm"]) if cache is None else None
    new_layers = []
    for i, bp in enumerate(params["layers"]):
        bc = cache["layers"][i] if cache is not None else None
        block = functools.partial(_apply_block, bp, cfg=cfg, kind=kind_at(cfg, i),
                                  positions=positions, shared_params=params.get("shared_attn"),
                                  enc_out=enc_out, cache=bc, cache_len=cache_len, impl=impl,
                                  layout=layout)
        if remat is None:
            x, nc = block(x, aux=aux)
        else:
            x, layer_aux = remat(_with_aux, block, x)
            if aux is not None:
                aux.append(layer_aux)
            nc = None
        new_layers.append(nc)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cache is None:
        return x, None
    return x, {"pos": cache["pos"] + (1 if decode else t), "layers": new_layers}


def _with_aux(block, x):
    """``block(x)``'s hidden state and its MoE losses summed (0 for a dense
    layer), as the two outputs of one recomputed function."""
    aux = []
    x, _ = block(x, aux=aux)
    return x, sum(aux, torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def check_trainable(cfg: ArchConfig, layout=None) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item that brings
    what ``cfg`` needs and the port cannot train yet."""
    missing = []
    kinds = sorted(set(cfg.layer_pattern) & set("mr"))
    if kinds:
        missing.append(f"the layer kinds {kinds}: backward kernels for mamba_scan and "
                       "rwkv_scan (item 7c)")
    if layout is not None and (layout.data > 1 or layout.model > 1):
        missing.append("a layout of several ranks: multi-rank training (item 7d)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: training does not take "
                                  + "; ".join(missing) + " (ROADMAP Queue 1)")


def loss_fn(params, cfg: ArchConfig, batch: dict, *, impl: str = "auto"):
    """Next-token loss (the port of ``repro/models/lm.py:464-503``):
    ``batch`` holds ``tokens`` (B, T+1) and optionally ``patch_embeds``,
    ``src_embeds`` and a float32 ``loss_mask`` (B, T).  Returns
    (loss, {"nll", "aux"}): the masked mean NLL of ``tokens[:, 1:]`` given
    ``tokens[:, :-1]`` (the patch positions dropped first), plus the MoE
    loss sum, plus 0.3 of the MTP head's NLL of the token after next
    where ``cfg.mtp``."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    patches = batch.get("patch_embeds")
    aux_l = []
    h, _ = forward(params, cfg, inputs, patch_embeds=patches,
                   src_embeds=batch.get("src_embeds"), impl=impl, aux=aux_l)
    if patches is not None:
        h = h[:, patches.shape[1]:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    table = head_table(params, cfg)
    nll = L.chunked_softmax_xent(h, table, targets, mask, chunk=cfg.xent_chunk,
                                 vocab_real=cfg.vocab)
    aux = sum(aux_l, torch.zeros((), dtype=torch.float32, device=h.device))
    loss = nll + aux

    if cfg.mtp and h.shape[1] > 2:
        # multi-token prediction: predict t+2 from [h_t ; emb(x_{t+1})]
        emb_next = L.embed_lookup_dense(params["embed"], targets)
        h2 = torch.cat([h, emb_next.to(h.dtype)], dim=-1) @ params["mtp_proj"]
        positions = torch.arange(h2.shape[1], dtype=torch.int32,
                                 device=h2.device)[None].expand(h2.shape[:2])
        h2, _ = _apply_block(params["mtp_block"], h2, cfg, "g", positions=positions,
                             impl=impl)
        h2 = L.rms_norm(h2, params["mtp_norm"], cfg.norm_eps)
        t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        m2 = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, -1:])], dim=1)
        loss = loss + 0.3 * L.chunked_softmax_xent(h2, table, t2, m2, vocab_real=cfg.vocab)
    return loss, {"nll": nll.detach(), "aux": aux.detach()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def head_table(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _mask_pad_vocab(logits, cfg):
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)


def _logits(h, params, cfg, layout):
    """The last position's logits over the whole (padded) vocab."""
    table = head_table(params, cfg)
    return _mask_pad_vocab(
        L.output_logits(h[:, -1], table, None if layout is None else layout.model_bk), cfg)


def prefill(params, cfg: ArchConfig, batch: dict, cache_len: int, *, impl: str = "auto",
            layout=None):
    """Run the prompt, build the cache, return (cache, last_logits).

    batch: ``tokens`` (B,T), and ``patch_embeds`` (B,P,D) or ``src_embeds``
    (B,S,D) as the frontend gives them.  ``cache_len`` must hold the
    patches too: ``pos`` advances by P + T.  The cross cache is sized to
    the source (S positions; 0 without ``src_embeds``).  With a
    ``layout``, every model rank of a data group returns the same logits."""
    tokens, src = batch["tokens"], batch.get("src_embeds")
    cache = cache_init(cfg, tokens.shape[0], cache_len, tokens.device,
                       cross_len=0 if src is None else src.shape[1], layout=layout)
    h, new_cache = forward(params, cfg, tokens, patch_embeds=batch.get("patch_embeds"),
                           src_embeds=src, cache=cache, decode=False, impl=impl,
                           layout=layout)
    return new_cache, _logits(h, params, cfg, layout)


def decode_step(params, cfg: ArchConfig, cache, tokens, *, impl: str = "auto", layout=None):
    """One token in, one logits row out; the cache advances by one (its
    buffers are written in place)."""
    h, new_cache = forward(params, cfg, tokens, cache=cache, decode=True, impl=impl,
                           layout=layout)
    return _logits(h, params, cfg, layout), new_cache
