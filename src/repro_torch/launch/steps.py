"""Step builders (the port of ``repro/launch/steps.py``).

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  prefill_step(params, batch)          -> (cache, logits)
  serve_step(params, cache, tokens)    -> (logits, cache)

Each closes over the config and the kernel choice ``impl``; the cache is
whatever ``lm.cache_init`` makes for the config (K/V, MLA's latents, the
recurrent state of zamba2-7b's and rwkv6-1.6b's mixers, or an
encoder-decoder's cross K/V).  The prefill batch carries the frontend's
``patch_embeds`` or ``src_embeds`` beside ``tokens``, as in the JAX
package.  With a ``layout`` (``models/sharding.Layout``) each serving step
runs this rank's part of the multi-rank LM; the parameters and caches are
the rank's own (``sharding.shard_params``, ``lm.cache_init``), so no
sharding trees are built.

The train step runs on one rank (``lm.check_trainable`` refuses what it
does not take, with the ROADMAP item that brings it): gradients by
autograd through ``lm.loss_fn`` (on the card the attention backward is the
hand-written kernel), then ``optim.adamw_update``, which writes the new
parameters and moments in place, with weight decay where the JAX package
applies it (``decay_mask``).  ``train_shardings`` has no counterpart
at one rank; ``abstract_state`` gives the shapes on the ``meta`` device.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def opt_config_for(cfg: ArchConfig) -> AdamWConfig:
    return AdamWConfig(moment_dtype=cfg.optimizer_dtype,
                       factored=cfg.factored_second_moment)


def trainable(params):
    """``params`` with every leaf recording gradients (in place)."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return params


def decay_mask(cfg: ArchConfig, params) -> dict:
    """Which leaves AdamW decays, as the JAX package's ``adamw_update`` picks
    them (two or more dims) on its layout: there each layer of the repeating
    units and each encoder block is stacked on a leading axis for ``scan``,
    so their norm gains count as 2-D and decay, while the prefix and
    remainder layers' do not."""
    prefix = cfg.moe.first_k_dense if cfg.moe else 0
    unit = len(cfg.layer_pattern)
    stacked = range(prefix, prefix + (cfg.n_layers - prefix) // unit * unit)
    out = tree.map_tree(lambda p: p.dim() >= 2, params)
    for i in stacked:
        out["layers"][i] = tree.map_tree(lambda p: p.dim() >= 1, params["layers"][i])
    if "encoder" in params:
        out["encoder"] = tree.map_tree(lambda p: p.dim() >= 1, params["encoder"])
    return out


def make_train_step(cfg: ArchConfig, impl: str = "auto", layout=None):
    """``train_step(params, opt_state, batch)``: the loss's gradients (with
    ``cfg.grad_accum > 1``, float32 gradients averaged over that many
    microbatches of the batch's rows, and the loss and metrics averaged, as
    JAX's scan does), then AdamW.  Metrics: ``loss``, ``nll``, ``aux`` and
    ``grad_norm``, float32 0-d tensors."""
    lm.check_trainable(cfg, layout)
    ocfg = opt_config_for(cfg)
    accum = max(1, cfg.grad_accum)

    def grads_of(params, batch):
        leaves = tree.leaves(params)
        loss, metrics = lm.loss_fn(params, cfg, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum)]
            grads = tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params)
            losses, metricses = [], []
            for mb in micro:
                loss_i, m_i, g = grads_of(params, mb)
                with torch.no_grad():
                    tree.map_tree(lambda a, gg: a.add_(gg.float() / accum), grads, g)
                del g
                losses.append(loss_i)
                metricses.append(m_i)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        params, opt_state, om = adamw_update(ocfg, params, grads, opt_state,
                                             decay=decay_mask(cfg, params))
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def abstract_state(cfg: ArchConfig):
    """(params, opt_state) on the ``meta`` device: shapes and dtypes only."""
    params = lm.abstract_params(cfg)
    return params, adamw_init(opt_config_for(cfg), params)


def init_state(cfg: ArchConfig, gen: torch.Generator | None, device):
    """Parameters from ``gen`` on ``device``, recording gradients, and
    zeroed AdamW state (the JAX package's ``init_state`` at one rank)."""
    params = trainable(lm.init_params(cfg, gen, device))
    return params, adamw_init(opt_config_for(cfg), params)


def make_prefill_step(cfg: ArchConfig, cache_len: int, impl: str = "auto", layout=None):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len=cache_len, impl=impl, layout=layout)

    return prefill_step


def make_serve_step(cfg: ArchConfig, impl: str = "auto", layout=None):
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens, impl=impl, layout=layout)

    return serve_step
