"""Step builders of the serving path (the port of ``repro/launch/steps.py:72-89``).

  prefill_step(params, batch)     -> (cache, logits)
  serve_step(params, cache, tokens) -> (logits, cache)

Each closes over the config and the kernel choice ``impl``; the cache is
whatever ``lm.cache_init`` makes for the config (K/V, MLA's latents, the
recurrent state of zamba2-7b's and rwkv6-1.6b's mixers, or an
encoder-decoder's cross K/V).  The prefill batch carries the frontend's
``patch_embeds`` or ``src_embeds`` beside ``tokens``, as in the JAX
package.  With a ``layout`` (``models/sharding.Layout``) each step runs
this rank's part of the multi-rank LM; the parameters and caches are the
rank's own (``sharding.shard_params``, ``lm.cache_init``), so no sharding
trees are built.  The train step waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ArchConfig, cache_len: int, impl: str = "auto", layout=None):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len=cache_len, impl=impl, layout=layout)

    return prefill_step


def make_serve_step(cfg: ArchConfig, impl: str = "auto", layout=None):
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens, impl=impl, layout=layout)

    return serve_step
