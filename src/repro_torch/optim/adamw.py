"""AdamW with large-model memory policies (the port of ``repro/optim/adamw.py``).

  * moment dtype policy (float32 by default; bf16 moments are stored in
    bf16 and updated in float32);
  * Adafactor-style factored second moment for matrices of at least
    ``factored_min_size`` on both trailing dims (row and column statistics
    in float32, floored at 1e-30);
  * global-norm clipping, decoupled weight decay on leaves of two or more
    dims only.

The state is ``{"step": int32 0-d, "per_param": tree}``, ``per_param``
mirroring the parameter tree with a dict of moments at each leaf.
``adamw_update`` runs under ``torch.no_grad()`` and writes the new
parameters and moments into the tensors it was given (the JAX package
returns new arrays; at 1.6 B parameters a second copy of the parameters
and moments would cost 16 GB).  ``opt_shardings`` has no counterpart at
one rank: each rank's moments are shaped like its own parameters, so
multi-rank training (ROADMAP Queue 1 item 7d) needs no sharding tree.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    factored: bool = False           # factored v for >=2-D params
    factored_min_size: int = 128


def _is_factored(cfg: AdamWConfig, shape) -> bool:
    return (cfg.factored and len(shape) >= 2 and
            shape[-1] >= cfg.factored_min_size and
            shape[-2] >= cfg.factored_min_size)


def adamw_init(cfg: AdamWConfig, params) -> dict:
    """Zero moments shaped like ``params`` (on each parameter's device)."""
    mdt = _DTYPES[cfg.moment_dtype]

    def one(p):
        st = {"m": torch.zeros(p.shape, dtype=mdt, device=p.device)}
        if _is_factored(cfg, p.shape):
            st["vr"] = torch.zeros(p.shape[:-1], dtype=_F32, device=p.device)
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32, device=p.device)
        else:
            st["v"] = torch.zeros(p.shape, dtype=mdt, device=p.device)
        return st

    first = tree.leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "per_param": tree.map_tree(one, params)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0, decay=None):
    """Returns (params, state, metrics): the same trees, updated in place,
    and ``{"grad_norm"}`` (float32 0-d, before clipping).  ``decay``, a tree
    of bools shaped like ``params``, says which leaves take weight decay
    (default: those of two or more dims)."""
    step = state["step"] + 1
    sf = step.to(_F32)

    gsq = sum(g.to(_F32).square().sum() for g in tree.leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    bc1 = 1 - torch.full_like(sf, cfg.b1) ** sf
    bc2 = 1 - torch.full_like(sf, cfg.b2) ** sf
    lr = cfg.lr * lr_scale

    def one(p, g, st, dec):
        g = g.to(_F32) * scale
        m = cfg.b1 * st["m"].to(_F32) + (1 - cfg.b1) * g
        if "vr" in st:
            g2 = g.square() + 1e-30
            vr = cfg.b2 * st["vr"] + (1 - cfg.b2) * g2.mean(dim=-1)
            vc = cfg.b2 * st["vc"] + (1 - cfg.b2) * g2.mean(dim=-2)
            del g2
            # rank-1 reconstruction (Adafactor)
            denom = vr[..., None] * vc[..., None, :] / torch.clamp(
                vr.mean(dim=-1)[..., None, None], min=1e-30)
            v_hat = denom / bc2
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        else:
            v = cfg.b2 * st["v"].to(_F32) + (1 - cfg.b2) * g.square()
            v_hat = v / bc2
            st["v"].copy_(v)
        st["m"].copy_(m)
        del g
        upd = (m / bc1) / (torch.sqrt(v_hat) + cfg.eps)
        del m, v_hat
        wd = cfg.weight_decay if (p.dim() >= 2 if dec is None else dec) else 0.0
        p32 = p.to(_F32)
        p.copy_(p32 - lr * (upd + wd * p32))
        return p

    if decay is None:
        decay = tree.map_tree(lambda _: None, params)
    tree.map_tree(one, params, grads, state["per_param"], decay)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
