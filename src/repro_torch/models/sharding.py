"""The ``(data, model)`` layout of ranks and the parameter rules (the port of
``repro/models/sharding.py``).

The JAX package names a mesh's axes and lets GSPMD place each parameter by
its ``PartitionSpec``; here each rank is a process, and a :class:`Layout`
says where it stands: ``data`` x ``model`` ranks, rank ``g`` of the group
at ``(g // model, g % model)`` as the JAX mesh orders its devices, and one
:class:`~repro_torch.core.backend.Backend` per axis.

  data axis   the batch: each data rank serves its own slots.  Parameters
              are replicated over it (the JAX package's FSDP split, a
              training knob, is not taken).
  model axis  tensor parallelism: attention heads, the MLP's hidden
              width and the vocabulary; MoE experts; the context-parallel
              MLA cache's sequence; Mamba2's and RWKV-6's heads.

:func:`param_spec` keeps the JAX package's rules by leaf name, as the dim
of each leaf split over the model axis (or ``None``), and
:func:`shard_params` slices a whole LM tree for one rank.  GSPMD gathers
behind a split that gives a device no whole heads; a process cannot, so
where JAX's rule cuts through a head the port gives each rank whole heads
instead, on purpose:

- ``wk``/``wv`` where ``n_kv_heads % P != 0`` and ``P % n_kv_heads == 0``:
  each rank holds its query group's K/V heads whole (:data:`KV_GROUP`),
  the layout JAX's ``cache_shardings`` gives the cache there
  (``kv_cache_rep``: the cache's heads replicated).
- Mamba2's ``in_proj``, whose columns are ``[z | x | B | C | dt]``
  (inner, inner, d_state, d_state and n_heads wide): JAX splits them
  contiguously.  A rank holds the ``z``, ``x`` and ``dt`` columns of its
  heads and all ``2 * d_state`` B/C columns, which every head reads
  (ngroups = 1) (:data:`MAMBA_IN`); ``conv_w`` its ``x`` channels and all
  B/C channels (:data:`MAMBA_CONV`; JAX replicates it).  ``a_log``,
  ``dt_bias``, ``d_skip`` and the gated norm's ``norm`` are cut to the
  rank's heads, and RWKV-6's bonus ``u`` and ``ln_x`` too (JAX replicates
  all six): a rank holds what its heads read.  RWKV's ``ww``, ``w0`` and
  ``mu`` stay replicated, as in JAX; each rank takes its heads' columns
  of the decay.

Any other split that does not divide raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.backend import Backend, ProcessGroupBackend, SerialBackend
from repro_torch.models import ssm as ssm_mod

#: ``param_spec``'s answer for ``wk``/``wv`` when the kv heads are fewer
#: than the model ranks: this rank's query group's K/V heads, whole
KV_GROUP = "kv_group"
#: ``param_spec``'s answer for Mamba2's ``in_proj``: the ``z``, ``x`` and
#: ``dt`` columns of this rank's heads, and every B/C column
MAMBA_IN = "mamba_in"
#: ``param_spec``'s answer for Mamba2's ``conv_w``: this rank's ``x``
#: channels, and every B/C channel
MAMBA_CONV = "mamba_conv"


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this rank stands on a ``data`` x ``model`` grid of ranks, and
    one backend per axis (a ``SerialBackend`` where the axis has size 1)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_bk: Backend
    model_bk: Backend

    @property
    def size(self) -> int:
        return self.data * self.model

    @classmethod
    def serial(cls) -> "Layout":
        """One rank."""
        return cls(1, 1, 0, 0, SerialBackend(), SerialBackend())

    @classmethod
    def over(cls, data: int, model: int, group=None) -> "Layout":
        """The layout over an initialized ``torch.distributed`` group of
        ``data * model`` ranks (the default group when ``group`` is None);
        the caller picks its backend (gloo, NCCL).  Collective over the
        group: every rank builds the same subgroups in the same order."""
        n = dist.get_world_size(group)
        if data * model != n:
            raise ValueError(f"layout {data} x {model} over a group of {n} ranks")
        g = dist.get_rank(group)
        glob = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))

        def axis(size: int, members) -> Backend:
            if size == 1:
                return SerialBackend()
            if size == n:
                return ProcessGroupBackend(group)
            mine = None
            for ranks in members:
                handle = dist.new_group([glob(r) for r in ranks])
                if g in ranks:
                    mine = handle
            return ProcessGroupBackend(mine)

        model_bk = axis(model, [[d * model + m for m in range(model)] for d in range(data)])
        data_bk = axis(data, [[d * model + m for d in range(data)] for m in range(model)])
        return cls(data, model, g // model, g % model, data_bk, model_bk)


def of(layout: Layout | None) -> Layout:
    """``layout``, or one rank for None."""
    return Layout.serial() if layout is None else layout


def kv_split(cfg, nm: int) -> str:
    """How ``n_kv_heads`` meet ``nm`` model ranks: ``"split"`` (whole heads
    a rank), ``"group"`` (ranks share their query group's heads) or
    ``"none"`` (neither divides)."""
    if cfg.n_kv_heads % nm == 0:
        return "split"
    return "group" if nm % cfg.n_kv_heads == 0 else "none"


def check_layout(cfg, layout: Layout | None) -> None:
    """Raise ``ValueError`` for what the layout cannot split, naming it."""
    lay = of(layout)
    if lay.size == 1:
        return
    nm = lay.model
    kinds = set(cfg.layer_pattern)
    attention = bool(kinds & set("gla")) or cfg.encoder_layers > 0
    dims = {"padded_vocab": cfg.padded_vocab, "d_ff": cfg.d_ff}
    if attention:
        dims["n_heads"] = cfg.n_heads
    if "m" in kinds:
        dims["Mamba2's n_heads"] = ssm_mod.mamba_dims(cfg)[1]
    if "r" in kinds:
        dims["RWKV-6's heads"] = ssm_mod.rwkv_dims(cfg)[0]
    if cfg.moe is not None:
        dims["n_experts"] = cfg.moe.n_experts
        if cfg.moe.shared_experts:
            dims["expert_d_ff * shared_experts"] = cfg.moe.expert_d_ff * cfg.moe.shared_experts
    for name, n in dims.items():
        if n % nm:
            raise ValueError(f"{cfg.name}: {name} = {n} does not split over {nm} model ranks")
    if attention and cfg.mla is None and kv_split(cfg, nm) == "none":
        raise ValueError(f"{cfg.name}: n_kv_heads = {cfg.n_kv_heads} neither splits over nor "
                         f"groups {nm} model ranks")


def _name(path: tuple) -> str:
    return [p for p in path if isinstance(p, str)][-1]


def param_spec(cfg, path: tuple, ndim: int, nm: int = 1) -> int | str | None:
    """The dim of the leaf at ``path`` (a tuple of dict keys and list
    indices, as ``lm._leaves`` walks the tree) split over ``nm`` model
    ranks, ``None`` where it is replicated, or one of :data:`KV_GROUP`,
    :data:`MAMBA_IN` and :data:`MAMBA_CONV`.  The JAX package's rules,
    matched on the leaf's name (``param_spec``,
    ``repro/models/sharding.py:50-115``), but for the whole-head splits
    the module docstring lists."""
    name = _name(path)
    keys = [p for p in path if isinstance(p, str)]
    owner = keys[-2] if len(keys) > 1 else None
    if (name in ("wk", "wv") and owner in ("attn", "xattn")
            and cfg.mla is None and kv_split(cfg, nm) == "group"):
        return KV_GROUP
    if owner == "mamba" and name in ("in_proj", "conv_w"):
        return MAMBA_IN if name == "in_proj" else MAMBA_CONV
    if name in ("embed", "lm_head"):
        dim = 0
    elif "experts" in keys and name in ("w_in", "w_gate", "w_out"):
        dim = 0
    elif name in ("wq", "wk", "wv", "w_uq", "w_ukv", "wr", "wg", "w_in", "w_gate"):
        dim = 1
    elif name in ("wo", "out_proj", "w_out"):
        dim = 0
    elif (owner == "mamba" and name in ("a_log", "dt_bias", "d_skip", "norm")) or (
            owner == "rwkv" and name in ("u", "ln_x")):
        dim = 0     # per head (norm, ln_x: per channel of the rank's heads)
    else:       # router, moe_bias, MLA's down-projections, norms, mixing vectors, ww, w0
        dim = None
    return dim if dim is not None and dim < ndim else None


def _mamba_columns(cfg, nm: int, r: int, conv: bool) -> torch.Tensor:
    """Model rank ``r``'s columns of Mamba2's ``in_proj`` (``[z | x | B |
    C | dt]``) or, with ``conv``, of ``conv_w`` (``[x | B | C]``)."""
    inner, nh, _ = ssm_mod.mamba_dims(cfg)
    ds = cfg.ssm.d_state
    il, hl = inner // nm, nh // nm          # check_layout: the heads split

    def mine(lo: int, n: int) -> torch.Tensor:
        return torch.arange(lo + r * n, lo + (r + 1) * n)
    if conv:
        return torch.cat([mine(0, il), torch.arange(inner, inner + 2 * ds)])
    return torch.cat([mine(0, il), mine(inner, il), torch.arange(2 * inner, 2 * inner + 2 * ds),
                      mine(2 * inner + 2 * ds, hl)])


def rank_slice(t: torch.Tensor, spec, cfg, layout: Layout, path: tuple = ()) -> torch.Tensor:
    """This rank's part of the whole leaf ``t`` under ``spec``: a fresh
    contiguous tensor where it is split, ``t`` itself where replicated."""
    nm, r = layout.model, layout.model_rank
    if spec is None or nm == 1:
        return t
    if spec == KV_GROUP:
        hd = cfg.head_dim
        g = r // (nm // cfg.n_kv_heads)
        return t[:, g * hd:(g + 1) * hd].clone()
    if spec in (MAMBA_IN, MAMBA_CONV):
        return t[:, _mamba_columns(cfg, nm, r, spec == MAMBA_CONV).to(t.device)]
    n = t.shape[spec]
    if n % nm:
        raise ValueError(f"{'/'.join(map(str, path))}: dim {spec} of {n} does not split over "
                         f"{nm} model ranks")
    return t.narrow(spec, r * (n // nm), n // nm).clone()


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params, cfg, layout: Layout | None, prefix: tuple = ()):
    """The whole tree ``params`` (an LM's, or a subtree whose path from
    the LM's root is ``prefix``) as this rank holds it."""
    check_layout(cfg, layout)
    lay = of(layout)
    return _map(params, lambda path, t: rank_slice(
        t, param_spec(cfg, path, t.dim(), lay.model), cfg, lay, path), prefix)

