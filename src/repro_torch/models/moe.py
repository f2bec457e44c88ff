"""Mixture-of-Experts with BCL-exchange token dispatch (the port of
``repro/models/moe.py``).

Expert dispatch is the many-to-many redistribution of BCL queues and
ISx.  One call of :func:`moe_apply`:

  1. registers the token routing AND a per-expert stats flow on one
     :class:`~repro_torch.core.exchange.ExchangePlan` (one binning pass,
     one ragged all-to-all for both flows); the stats flow asks each
     expert's owner for its post-capacity served-token count, so every
     rank learns the global expert load with no extra collective;
  2. bins the arrivals per local expert (a stable sort) and runs the
     batched expert FFN;
  3. sends the expert outputs and the stats replies back through one
     inverse all-to-all (``CommittedPlan.finish``) and merges them with
     the router weights.

Parallelism: a :class:`~repro_torch.models.sharding.Layout` in place of
the JAX package's ``(mesh, axes)``.  Over the model axis rank ``r`` holds
experts ``[r*E/P, (r+1)*E/P)`` (``sharding.shard_params``; ``E % P != 0``
is refused, as JAX's ``shard_map`` refuses it); the shared expert and the
dense residual MLP are tensor-parallel like the MLP, with one ``psum``.
Every model rank of a data group is given the group's whole ``x`` and
each token is dispatched once, by one rank: when ``T % P == 0`` each rank
takes its slice of the sequence (the JAX ``shard_map``'s split, bit for
bit); otherwise, when ``B*T % P == 0``, rows ``[r*B*T/P, (r+1)*B*T/P)``
of the flattened tokens, which is JAX's split of ``x.reshape(1, B*T, D)``
with the same capacities; otherwise ``ValueError``.  The outputs are
all-gathered, so every rank returns the same ``y``.  (JAX's own
``moe_apply`` at ``T % P != 0`` has every rank dispatch every token and
returns the first rank's output: each owner's bins get P copies of each
token and drop the later ranks'.)  The batch is split over the data axis
by the caller; ``expert_load`` and ``dispatch_dropped`` are summed over it,
as JAX's ``load.sum(axis=0)`` does, and so is the aux loss's routing.
The capacities are the JAX package's formulas.  On the card the wire runs
the exchange's kernels (``multi_bin_offsets``, ``pack_rows``,
``place_rows``); ``impl="torch"`` takes their plain versions.

Gradients (one rank; ``lm.check_trainable`` refuses several): the float
lanes of the token flow (the activations and, under dedup, the router
weights) carry their cotangents back over the wire by the exchange's
transposes (``CommittedPlan.transposer``): an owner row's cotangent goes
back along the reply direction, a reply's along the request direction,
on the forward commit's maps, through the same kernels (or plain
versions), in the flow's wire dtype (a bf16 rounding passes the gradient
through unchanged, as JAX's ``astype`` does), recording nothing in the
cost log.  A copy the wire dropped, or that its expert's bin could not
hold, gets a zero cotangent, as its output is zero.  The int lanes carry
none.  This is the gradient the JAX package's docstring defines
(``repro/models/moe.py:25-27``); its code bitcasts the float lanes to
u32 words (``_pack_act``, ``_unpack_act``, the dedup weights), and
``jax.grad`` through ``bitcast_convert_type`` is zero, so there no expert
weight gets a gradient (ROADMAP Queue 3, records).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.exchange import ExchangePlan
from repro_torch.core.transport import make_transport
from repro_torch.models import layers as L
from repro_torch.models import sharding

_F32 = torch.float32
_I32 = torch.int32
#: float32 elements of one block of a per-owner reply's weighted products
_REPLY_BLOCK = 1 << 26


def _experts(gen, n: int, shape: tuple, scale: float, dtype, device,
             keep: slice) -> torch.Tensor:
    """Experts ``keep`` of an (n, *shape) ``N(0, 1) * scale`` stack: all n
    drawn one at a time, in order, the kept ones into a preallocated
    tensor of ``dtype``, so the float32 draw of the whole stack never
    exists."""
    lo, hi, _ = keep.indices(n)
    out = torch.empty((hi - lo, *shape), dtype=dtype, device=device)
    if out.is_meta:
        return out
    for i in range(n):
        w = L.normal(gen, shape, scale, dtype, device)
        if lo <= i < hi:
            out[i - lo] = w
    return out


def moe_init(gen: torch.Generator, cfg, dtype, device, experts: slice | None = None) -> dict:
    """Router float32 (D, E); experts ``w_gate``/``w_in`` (E, D, F) and
    ``w_out`` (E, F, D), or only the slice ``experts`` of each stack (the
    whole sequence is drawn all the same); ``shared``, ``dense`` and
    ``moe_bias`` as the config asks.  The JAX package's shapes, scales and
    dtypes; the draws differ."""
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.expert_d_ff, mo.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    keep = slice(None) if experts is None else experts
    p = {"router": L.normal(gen, (d, e), s_in, _F32, device),
         "experts": {"w_gate": _experts(gen, e, (d, f), s_in, dtype, device, keep),
                     "w_in": _experts(gen, e, (d, f), s_in, dtype, device, keep),
                     "w_out": _experts(gen, e, (f, d), s_out, dtype, device, keep)}}
    if mo.shared_experts:
        p["shared"] = L.mlp_init(gen, d, f * mo.shared_experts, cfg.activation, dtype, device)
    if mo.dense_residual:
        p["dense"] = L.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype, device)
    if mo.bias_update_rate > 0:
        p["moe_bias"] = torch.zeros(e, dtype=_F32, device=device)
    return p


def _pack_act(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """(N, D) activations -> int32 wire lanes: float32 bit-views, or two
    bf16 values per lane (the even element in the low half, as the JAX
    package's ``bitcast_convert_type`` lays them out).  The words carry no
    gradient: :class:`_Delivered` and :class:`_Replied` carry it."""
    t = x.detach().to(torch.bfloat16 if bf16 else _F32).contiguous()
    return t.view(_I32)


def _unpack_act(lanes: torch.Tensor, bf16: bool) -> torch.Tensor:
    if not bf16:
        return lanes.view(_F32)
    return lanes.contiguous().view(torch.bfloat16).float()


class _Delivered(torch.autograd.Function):
    """The float lanes a committed flow delivered, as owner-side rows: one
    output per section ``(lo, hi, bf16)`` of the view's payload words.  The
    forward unpacks what the commit moved; the backward packs the outputs'
    cotangents in the same wire dtypes and carries them back along the
    reply direction in one trip (``FlowTranspose.route``) to the gradients
    of ``srcs``, the requester-side rows the sections were packed from."""

    @staticmethod
    def forward(ctx, tr, bk, view, sections, *srcs):
        ctx.tr, ctx.bk, ctx.sections = tr, bk, sections
        ctx.dtypes = tuple(t.dtype for t in srcs)
        return tuple(_unpack_act(view.payload[:, lo:hi], bf16) for lo, hi, bf16 in sections)

    @staticmethod
    def backward(ctx, *gs):
        m = ctx.tr.arrived.shape[0]
        words = torch.cat([_pack_act(torch.zeros((m, (hi - lo) * (2 if bf16 else 1)),
                                                 device=ctx.tr.arrived.device)
                                     if g is None else g, bf16)
                           for g, (lo, hi, bf16) in zip(gs, ctx.sections)], dim=1)
        back = ctx.tr.route(ctx.bk, words)
        out, w0 = [], 0
        for (lo, hi, bf16), dt in zip(ctx.sections, ctx.dtypes):
            out.append(_unpack_act(back[:, w0:w0 + hi - lo], bf16).to(dt))
            w0 += hi - lo
        return (None, None, None, None, *out)


class _Replied(torch.autograd.Function):
    """The float replies a committed flow landed (``finish``'s words,
    unpacked); the backward carries their cotangent, in the wire dtype, to
    the owners along the request direction (``FlowTranspose.reply``): the
    gradient of ``src``, the owner-side rows the replies were packed from."""

    @staticmethod
    def forward(ctx, tr, bk, landed, bf16, src):
        ctx.tr, ctx.bk, ctx.bf16, ctx.dtype = tr, bk, bf16, src.dtype
        return _unpack_act(landed[0], bf16)

    @staticmethod
    def backward(ctx, g):
        seg = ctx.tr.reply(ctx.bk, _pack_act(g, ctx.bf16))
        return None, None, None, None, _unpack_act(seg, ctx.bf16).to(ctx.dtype)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of ``0..n-1`` in ``ids`` (int64), without the
    host read of the largest id that ``torch.bincount`` makes on the card."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _bin_indices(expert, valid, n_groups: int, cap: int, m: int):
    """Slot assignment only: ``(flat_row_index (n_groups*cap,), slot (M,),
    ok (M,))``; -1 marks empty bin slots.  An item's rank in its group is
    its position in a stable sort by group."""
    dev = expert.device
    g = torch.where(valid, expert.to(_I32), n_groups).to(torch.int64)
    counts_full = _counts(g, n_groups + 1)
    start = torch.cumsum(counts_full, 0) - counts_full
    order = torch.argsort(g, stable=True)
    pos = torch.arange(m, device=dev) - start[g[order]]
    pos_orig = torch.empty_like(pos).scatter_(0, order, pos)
    ok = valid & (pos_orig < cap)
    slot = torch.where(ok, g * cap + pos_orig, n_groups * cap)
    binned_idx = torch.full((n_groups * cap + 1,), -1, dtype=_I32, device=dev)
    binned_idx[slot] = torch.arange(m, dtype=_I32, device=dev)
    return binned_idx[:-1], slot, ok


def _rows_at(src: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(len(idx), W): ``src[idx]`` where ``ok``, zeros (and a zero gradient)
    elsewhere, whatever ``idx`` holds there.  The bins' gathers: a slot
    with no copy, and a copy its expert's bin could not hold, read zeros."""
    return torch.where(ok[:, None], src[idx.clamp(0, src.shape[0] - 1).long()], 0)


def _gather_binned(rows, src, n_groups: int, cap: int) -> torch.Tensor:
    """(n_groups, cap, D): bin slot i holds ``rows[src[i]]``, or zeros
    where ``src[i]`` is -1."""
    return _rows_at(rows, src, src >= 0).reshape(n_groups, cap, -1)


def _stats_flow(plan: ExchangePlan, e: int, e_loc: int, device) -> int:
    """Register the per-expert stats flow: one row per global expert,
    asking that expert's owner for its served-token count.  Its capacity
    is exact (every rank sends ``e_loc`` rows to each owner), so it never
    drops, and ``max_rounds=1`` opts it out of the token flow's retries."""
    eid = torch.arange(e, dtype=_I32, device=device)
    return plan.add((eid % e_loc)[:, None], eid // e_loc, e_loc, reply_lanes=1,
                    op_name="moe.stats", max_rounds=1)


def _stats_reply(committed, handle: int, served: torch.Tensor) -> None:
    """Owner side: answer each stats request with its expert's count."""
    sv = committed.view(handle)
    lid = torch.where(sv.valid, sv.payload[:, 0], 0).long()
    committed.set_reply(handle, torch.where(sv.valid, served[lid], 0))


def _served(ids, ok, e_loc: int) -> torch.Tensor:
    """Tokens each local expert served (post-capacity), int32 (e_loc,)."""
    return _counts(torch.where(ok, ids, e_loc).long(), e_loc + 1)[:e_loc].to(_I32)


def _expert_ffn(binned, wg, wi, wo, activation: str) -> torch.Tensor:
    """Batched expert FFN: (E, C, D) rows through each expert's MLP."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else L.activation_fn("gelu")
        h = act(torch.bmm(binned, wg)) * torch.bmm(binned, wi)
    else:
        h = L.activation_fn(activation)(torch.bmm(binned, wi))
    return torch.bmm(h, wo)


def router_topk(params, x, cfg):
    """Router over x (B, T, D): ``(top_w (B,T,K), top_idx (B,T,K),
    gate_logits (B,T,E), scores (B,T,E))``; ``scores`` are what top-k
    picks from (softmax probabilities, or sigmoid + ``moe_bias``)."""
    k = cfg.moe.top_k
    gate_logits = torch.einsum("btd,de->bte", x.float(), params["router"])
    if "moe_bias" in params:
        scores = torch.sigmoid(gate_logits) + params["moe_bias"]
        top_idx = torch.topk(scores, k, dim=-1).indices
        top_p = torch.gather(torch.sigmoid(gate_logits), -1, top_idx)
        top_w = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    else:
        scores = torch.softmax(gate_logits, dim=-1)
        top_w, top_idx = torch.topk(scores, k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_w, top_idx, gate_logits, scores


def _always_on(extras, x, activation: str, bk):
    """The always-on MLPs' (shared/dense) summed output on x (None without
    them), tensor-parallel over ``bk``."""
    out = None
    for p in extras:
        o = L.mlp(p, x, activation, bk)
        out = o if out is None else out + o
    return out


def _commit(plan, bk, cfg, transport, impl, x, extras):
    """Commit the plan; under split-phase dispatch the always-on MLPs
    run on x between ``commit_async`` and ``finish``.  Returns
    ``(committed, window output | None)``."""
    if not cfg.moe_async_dispatch:
        return plan.commit(bk, impl=impl, max_rounds=cfg.moe_dispatch_rounds,
                           transport=transport), None
    pend = plan.commit_async(bk, impl=impl, max_rounds=cfg.moe_dispatch_rounds,
                             transport=transport)
    win = _always_on(extras, x, cfg.activation, bk)
    return pend.finish(bk), win


def _dispatch(xl, idxl, wl, experts, extras, x, cfg, bk, nm, e_loc, transport, impl):
    """One exchange row per (token, expert) pair."""
    mo = cfg.moe
    d, k, e = xl.shape[2], mo.top_k, mo.n_experts
    bl, tl = xl.shape[0], xl.shape[1]
    wg, wi, wo = experts["w_gate"], experts["w_in"], experts["w_out"]
    cap = max(1, int(bl * tl * k / nm * cfg.moe_capacity_slack) + 1)
    # expert bins scale with retry rounds (see _dispatch_dedup)
    e_cap = max(1, int(bl * tl * k * nm / e * cfg.moe_capacity_slack)
                + 1) * max(1, cfg.moe_dispatch_rounds)
    xx = xl.reshape(bl * tl, d).repeat_interleave(k, dim=0)      # (n, D)
    ee = idxl.reshape(-1).to(_I32)
    bf16 = cfg.moe_payload_dtype == "bfloat16"
    act_lanes = d // 2 if bf16 else d
    payload = torch.cat([_pack_act(xx, bf16), (ee % e_loc)[:, None]], dim=1)
    plan = ExchangePlan(name="moe.dispatch")
    h_tok = plan.add(payload, ee // e_loc, cap, reply_lanes=act_lanes,
                     op_name="moe.dispatch")
    h_st = _stats_flow(plan, e, e_loc, xl.device)
    c, win = _commit(plan, bk, cfg, transport, impl, x, extras)
    res = c.view(h_tok)
    tr = c.transposer(h_tok)

    rows, = _Delivered.apply(tr, bk, res, ((0, act_lanes, bf16),), xx)
    le = torch.where(res.valid, res.payload[:, act_lanes], e_loc)
    bin_idx, slot, okb = _bin_indices(le, res.valid, e_loc, e_cap, rows.shape[0])
    binned = _gather_binned(rows, bin_idx, e_loc, e_cap).to(wg.dtype)
    y = _expert_ffn(binned, wg, wi, wo, cfg.activation)          # (e_loc, e_cap, D)

    flat = y.reshape(e_loc * e_cap, d)
    back = _rows_at(flat, slot, okb).float()
    _stats_reply(c, h_st, _served(le, okb, e_loc))
    c.set_reply(h_tok, _pack_act(back, bf16))
    outs = c.finish(bk)
    load = outs[h_st][0][:, 0].float()
    yk = _Replied.apply(tr, bk, outs[h_tok], bf16, back).reshape(bl, tl, k, d)
    ybt = torch.einsum("btkd,btk->btd", yk, wl.float())
    return ybt, load, res.dropped, win


def _dispatch_dedup(xl, idxl, wl, experts, extras, x, cfg, bk, nm, e_loc, transport, impl):
    """One exchange row per (token, distinct owner rank): the owner runs
    all of its experts the token picked and replies their weighted sum."""
    mo = cfg.moe
    d, k, e = xl.shape[2], mo.top_k, mo.n_experts
    bl, tl = xl.shape[0], xl.shape[1]
    wg, wi, wo = experts["w_gate"], experts["w_in"], experts["w_out"]
    n_tok = bl * tl
    n = n_tok * k
    exp_owners = nm * (1.0 - (1.0 - 1.0 / nm) ** k)
    cap = max(1, int(n_tok * min(k, exp_owners) / nm * cfg.moe_capacity_slack) + 1)
    # retry rounds admit up to rounds x cap arrivals per (src, dst), so the
    # owner's expert bins scale with them or the rescued tokens would be
    # zeroed at the bin stage
    e_cap = max(1, int(n_tok * k * nm / e * cfg.moe_capacity_slack)
                + 1) * max(1, cfg.moe_dispatch_rounds)
    bf16 = cfg.moe_payload_dtype == "bfloat16"
    act_lanes = d // 2 if bf16 else d

    xx = xl.reshape(n_tok, d)
    ee = idxl.reshape(n_tok, k).to(_I32)
    ww = wl.reshape(n_tok, k).float()
    owners = ee // e_loc                                         # (n_tok, k)
    same = owners[:, :, None] == owners[:, None, :]              # (n_tok, j, i)
    first = ~torch.triu(same, 1).any(dim=2)                      # j is first
    # per (token, j) row: the local expert ids and weights of MY owner
    ids = torch.where(same, (ee % e_loc)[:, None, :], e_loc)
    wts = torch.where(same, ww[:, None, :], 0.0)
    xx_rep, wts_n = xx.repeat_interleave(k, dim=0), wts.reshape(n, k)
    payload = torch.cat([_pack_act(xx_rep, bf16), ids.reshape(n, k).to(_I32),
                         _pack_act(wts_n, False)], dim=1)
    plan = ExchangePlan(name="moe.dispatch")
    h_tok = plan.add(payload, owners.reshape(-1), cap, reply_lanes=act_lanes,
                     valid=first.reshape(-1), op_name="moe.dispatch")
    h_st = _stats_flow(plan, e, e_loc, xl.device)
    c, win = _commit(plan, bk, cfg, transport, impl, x, extras)
    res = c.view(h_tok)
    tr = c.transposer(h_tok)

    m = res.payload.shape[0]
    # the activations and the router weights: their gradients go back over the wire
    rows, w_m = _Delivered.apply(tr, bk, res, ((0, act_lanes, bf16),
                                               (act_lanes + k, act_lanes + 2 * k, False)),
                                 xx_rep, wts_n)                  # (M, D), (M, k)
    flat_ids = res.payload[:, act_lanes:act_lanes + k].reshape(-1)
    flat_w = w_m.reshape(-1)
    flat_valid = res.valid.repeat_interleave(k) & (flat_ids < e_loc)
    flat_row = torch.arange(m, device=xl.device).repeat_interleave(k)

    bin_idx, slot, okb = _bin_indices(flat_ids, flat_valid, e_loc, e_cap, m * k)
    src_row = torch.where(bin_idx >= 0, flat_row[bin_idx.clamp(min=0).long()], -1)
    binned = _gather_binned(rows, src_row, e_loc, e_cap).to(wg.dtype)
    y = _expert_ffn(binned, wg, wi, wo, cfg.activation)          # (e_loc, e_cap, D)

    flat_y = y.reshape(e_loc * e_cap, d).float()
    take = slot.clamp(max=e_loc * e_cap - 1)
    # each arrival row owns k consecutive entries: their sum is its reply,
    # taken a block of rows at a time so the (M*k, D) products never exist
    # whole (4 GB a temporary at deepseek-v3's width on four ranks)
    out_rows = torch.empty((m, d), dtype=_F32, device=xl.device)
    step = max(1, _REPLY_BLOCK // (k * d))
    for r0 in range(0, m, step):
        e = slice(r0 * k, min(m, r0 + step) * k)
        part = _rows_at(flat_y, take[e], okb[e]) * torch.where(okb[e], flat_w[e], 0)[:, None]
        out_rows[r0:r0 + step] = part.reshape(-1, k, d).sum(dim=1)

    _stats_reply(c, h_st, _served(flat_ids, okb, e_loc))
    c.set_reply(h_tok, _pack_act(out_rows, bf16))
    outs = c.finish(bk)
    load = outs[h_st][0][:, 0].float()
    yk = _Replied.apply(tr, bk, outs[h_tok], bf16, out_rows).reshape(n_tok, k, d)
    ybt = yk.sum(dim=1).reshape(bl, tl, d)                       # weights applied at owner
    return ybt, load, res.dropped, win


def token_split(b: int, t: int, nm: int) -> str:
    """How ``nm`` model ranks share the dispatch of (B, T) tokens:
    ``"seq"`` (each rank its T/P positions of every row), ``"rows"`` (each
    rank B*T/P rows of the flattened tokens) or, on one rank, ``"all"``."""
    if nm == 1:
        return "all"
    if t % nm == 0:
        return "seq"
    if b * t % nm == 0:
        return "rows"
    raise ValueError(f"moe_apply: neither T = {t} nor B*T = {b * t} splits over {nm} model "
                     f"ranks, and each token must be dispatched once")


def moe_apply(params, x, cfg, layout=None, *, impl: str = "auto"):
    """x (B, T, D), this data rank's batch -> ``(y, aux, stats)``.

    ``layout``: a :class:`~repro_torch.models.sharding.Layout` (None: one
    rank).  ``aux`` is the load-balance loss (GShard) over every data
    rank's tokens.  ``stats`` holds ``expert_load``, the global
    post-capacity served-token count per expert (E,) delivered by the
    stats flow, and ``dispatch_dropped``, the global count of token copies
    the wire could not admit.  A copy past its expert's bin capacity is
    served by no expert (its output row is zero), as in the JAX package;
    only wire drops are counted.
    """
    mo = cfg.moe
    b, t, d = x.shape
    e = mo.n_experts
    lay = sharding.of(layout)
    bk, dbk = lay.model_bk, lay.data_bk
    nm, nd = bk.nprocs(), dbk.nprocs()
    if e % nm:
        raise ValueError(f"moe_apply: n_experts = {e} does not split over {nm} model ranks")
    e_loc = e // nm
    experts = params["experts"]
    if experts["w_gate"].shape[0] != e_loc:
        raise ValueError(f"moe_apply: rank {bk.rank()} of {nm} holds "
                         f"{experts['w_gate'].shape[0]} experts, want {e_loc} "
                         f"(sharding.shard_params slices them)")
    top_w, top_idx, gate_logits, _ = router_topk(params, x, cfg)

    # load-balance aux loss (GShard), over every data rank's tokens
    probs_mean = torch.softmax(gate_logits, dim=-1).mean(dim=(0, 1))
    hard = torch.zeros(e, dtype=_F32, device=x.device).index_add_(
        0, top_idx.reshape(-1), torch.ones(top_idx.numel(), dtype=_F32, device=x.device))
    if nd > 1:
        probs_mean, hard = dbk.psum(probs_mean) / nd, dbk.psum(hard)
    hard = hard / hard.sum().clamp(min=1.0)
    aux = mo.aux_loss_coef * e * torch.sum(probs_mean * hard)

    # ---- dispatch over the model axis (the BCL exchange) ----
    transport = make_transport(cfg.exchange_transport)
    extras = [params[kk] for kk in ("shared", "dense") if kk in params]
    split = token_split(b, t, nm)
    xl, idxl, wl = x, top_idx, top_w
    r = bk.rank()
    if split == "seq":
        sl = slice(r * (t // nm), (r + 1) * (t // nm))
        xl, idxl, wl = x[:, sl], top_idx[:, sl], top_w[:, sl]
    elif split == "rows":
        sl = slice(r * (b * t // nm), (r + 1) * (b * t // nm))
        xl, idxl, wl = (a.reshape(1, b * t, -1)[:, sl] for a in (x, top_idx, top_w))
    dispatch = _dispatch_dedup if cfg.moe_dedup_dispatch else _dispatch
    y, load, dropped, win = dispatch(xl, idxl, wl, experts,
                                     extras if cfg.moe_async_dispatch else [], x, cfg, bk,
                                     nm, e_loc, transport, impl)
    y = y.to(x.dtype)
    if split != "all":          # every rank's share, in rank order
        y = torch.cat(list(bk.all_gather(y)), dim=1).reshape(b, t, d)
    if nd > 1:
        load, dropped = dbk.psum(load), dbk.psum(dropped)

    # ---- always-on paths (under async dispatch they ran in the window) ----
    if not cfg.moe_async_dispatch:
        win = _always_on(extras, x, cfg.activation, bk)
    if win is not None:
        y = y + win
    return y, aux, {"expert_load": load, "dispatch_dropped": dropped}
