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
              MLA cache's sequence.

:func:`param_spec` keeps the JAX package's rules by leaf name, as the dim
of each leaf split over the model axis (or ``None``), and
:func:`shard_params` slices a whole LM tree for one rank.  One deliberate
difference: where ``n_kv_heads % P != 0`` and ``P % n_kv_heads == 0`` the
JAX rule splits ``wk``/``wv`` columns through the middle of a head, and
GSPMD then gathers them; here each rank holds its query group's K/V heads
whole (:data:`KV_GROUP`), the layout JAX's ``cache_shardings`` gives the
cache there (``kv_cache_rep``: the cache's heads replicated).  Any other
split that does not divide raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.backend import Backend, ProcessGroupBackend, SerialBackend

#: ``param_spec``'s answer for ``wk``/``wv`` when the kv heads are fewer
#: than the model ranks: this rank's query group's K/V heads, whole
KV_GROUP = "kv_group"
#: the item of ROADMAP Queue 1 the refused kinds wait for
_LATER = "the recurrent kinds, the encoder-decoder and the frame frontend at P>1 wait " \
         "for ROADMAP Queue 1 item 6.2b"


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
    kinds = sorted(set(cfg.layer_pattern) - set("gl"))
    if kinds:
        raise ValueError(f"{cfg.name}: layer kinds {kinds} at {lay.data} x {lay.model} ranks: "
                         + _LATER)
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: the encoder-decoder at {lay.data} x {lay.model} ranks: "
                         + _LATER)
    nm = lay.model
    dims = {"n_heads": cfg.n_heads, "padded_vocab": cfg.padded_vocab, "d_ff": cfg.d_ff}
    if cfg.moe is not None:
        dims["n_experts"] = cfg.moe.n_experts
        if cfg.moe.shared_experts:
            dims["expert_d_ff * shared_experts"] = cfg.moe.expert_d_ff * cfg.moe.shared_experts
    for name, n in dims.items():
        if n % nm:
            raise ValueError(f"{cfg.name}: {name} = {n} does not split over {nm} model ranks")
    if cfg.mla is None and kv_split(cfg, nm) == "none":
        raise ValueError(f"{cfg.name}: n_kv_heads = {cfg.n_kv_heads} neither splits over nor "
                         f"groups {nm} model ranks")


def _name(path: tuple) -> str:
    return [p for p in path if isinstance(p, str)][-1]


def param_spec(cfg, path: tuple, ndim: int, nm: int = 1) -> int | str | None:
    """The dim of the leaf at ``path`` (a tuple of dict keys and list
    indices, as ``lm._leaves`` walks the tree) split over ``nm`` model
    ranks, ``None`` where it is replicated, or :data:`KV_GROUP`.  The JAX
    package's rules, matched on the leaf's name (``param_spec``,
    ``repro/models/sharding.py:50-115``)."""
    name = _name(path)
    keys = [p for p in path if isinstance(p, str)]
    if (name in ("wk", "wv") and len(keys) > 1 and keys[-2] in ("attn", "xattn")
            and cfg.mla is None and kv_split(cfg, nm) == "group"):
        return KV_GROUP
    if name in ("embed", "lm_head"):
        dim = 0
    elif "experts" in keys and name in ("w_in", "w_gate", "w_out"):
        dim = 0
    elif name in ("wq", "wk", "wv", "w_uq", "w_ukv", "in_proj", "wr", "wg", "w_in", "w_gate"):
        dim = 1
    elif name in ("wo", "out_proj", "w_out"):
        dim = 0
    else:       # router, moe_bias, MLA's down-projections, norms, mixing vectors
        dim = None
    return dim if dim is not None and dim < ndim else None


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

