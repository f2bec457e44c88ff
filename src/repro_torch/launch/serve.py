"""Batched serving: prefill + decode with slot-based batching.

The port of ``repro/launch/serve.py``: a fixed decode batch of
``--batch`` slots; each wave of queued requests is prefilled into the
slots (the last wave padded with zero prompts) and decoded greedily for
``--gen`` tokens.  It runs on the card unless ``--cpu`` is given, and
without a card it exits non-zero.  MoE models (arctic-480b) dispatch
their experts over the exchange.  The
recurrent models (zamba2-7b: Mamba2 with a shared attention block;
rwkv6-1.6b) carry their recurrent state in the cache, each mixer's scan
one kernel launch a layer and call on the card.

``serve`` also takes each request's frontend embeddings: ``patch_embeds``
(R, P, D) for a ``patch`` model (internvl2-76b: they go before the
prompt, and the cache holds them too) or ``src_embeds`` (R, S, D) for an
encoder-decoder (seamless-m4t-medium: encoded at the wave's prefill and
cross-attended at every step).  The CLI serves tokens only, as the JAX
package's does: it serves internvl2-76b without patches, and refuses an
encoder-decoder model, whose prefill needs its source (the JAX package's
fails there).

``serve(..., layout=...)`` serves over a ``(data, model)`` layout of
ranks (``models/sharding.Layout``, each rank a process calling ``serve``
with its own parameters): each wave's slots are split over the data
ranks, every model rank of a data group feeds the same tokens, and the
picks are all-gathered over the data axis, so every rank returns every
request's tokens.  The CLI serves on one rank, as the JAX package's does
(a 1 x 1 mesh).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --reduced --cpu \\
      --requests 16 --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --reduced --cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --reduced
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm


def serve(params, cfg, prompts: torch.Tensor, batch: int, gen: int, impl: str = "auto", *,
          patch_embeds: torch.Tensor | None = None, src_embeds: torch.Tensor | None = None,
          forced: torch.Tensor | None = None, on_logits=None,
          timings: dict | None = None, layout=None) -> dict[int, list[int]]:
    """Serve every prompt of ``prompts`` (R, P) greedily; returns each
    request's ``gen`` tokens by request index.

    ``layout``: the ranks (None: one).  ``batch`` counts every data
    rank's slots, and must split over them; this rank serves its
    ``batch / data`` slots of each wave, and ``on_logits`` sees their rows.

    ``patch_embeds`` (R, n_patch, D) or ``src_embeds`` (R, S, D), if given,
    are each request's frontend embeddings; each wave's prefill takes its
    rows (the last wave's padding rows zero).

    ``forced`` (R, gen), if given, is fed in place of the greedy picks
    (teacher forcing: a second run sees the first run's tokens).
    ``on_logits(wave, step, logits)`` sees each wave's prefill logits
    (step 0) and decode step n's logits (step n).  ``timings``, if given,
    gets ``prefill_s`` (per wave, prompt in to first token on the host)
    and ``decode_s`` (per decode step, token in to next token on the host).
    """
    n_req, prompt_len = prompts.shape
    embeds = {k: e for k, e in (("patch_embeds", patch_embeds), ("src_embeds", src_embeds))
              if e is not None}
    n_patch = 0 if patch_embeds is None else patch_embeds.shape[1]
    nd = 1 if layout is None else layout.data
    if batch % nd:
        raise ValueError(f"serve: {batch} slots do not split over {nd} data ranks")
    mine = slice(0, batch) if layout is None else \
        slice(layout.data_rank * (batch // nd), (layout.data_rank + 1) * (batch // nd))
    prefill_step = make_prefill_step(cfg, cache_len=n_patch + prompt_len + gen, impl=impl,
                                     layout=layout)
    decode = make_serve_step(cfg, impl=impl, layout=layout)
    if timings is not None:
        timings.setdefault("prefill_s", [])
        timings.setdefault("decode_s", [])

    def pick(logits, rows, step):
        """This rank's slots' tokens (B/data, 1), and every slot's picks."""
        tok = logits.argmax(dim=-1)[:, None]
        if forced is not None and step < gen:
            lo = rows.start + mine.start                    # this rank's first request
            n = max(0, min(rows.stop - lo, tok.shape[0]))   # its requests (not padding)
            tok[:n, 0] = forced[lo:lo + n, step].to(tok.dtype)
        every = tok if nd == 1 else \
            layout.data_bk.all_gather(tok.to(torch.int32)).reshape(batch, 1)
        return tok, every[:, 0].tolist()

    queue = list(range(n_req))
    outputs: dict[int, list[int]] = {i: [] for i in range(n_req)}
    wave = 0
    while queue:
        active, queue = queue[:batch], queue[batch:]
        rows = slice(active[0], active[0] + len(active))    # the queue is in order
        inputs = {"tokens": prompts[rows], **{k: e[rows] for k, e in embeds.items()}}
        if len(active) < batch:   # pad the last wave
            inputs = {k: torch.cat([x, x.new_zeros((batch - len(active), *x.shape[1:]))])
                      for k, x in inputs.items()}
        inputs = {k: x[mine] for k, x in inputs.items()}
        t0 = time.perf_counter()
        cache, logits = prefill_step(params, inputs)
        tok, picks = pick(logits, rows, 0)
        if timings is not None:
            timings["prefill_s"].append(time.perf_counter() - t0)
        if on_logits is not None:
            on_logits(wave, 0, logits)
        for step in range(gen):
            for j, rid in enumerate(active):
                outputs[rid].append(picks[j])
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            tok, picks = pick(logits, rows, step + 1)
            if timings is not None:
                timings["decode_s"].append(time.perf_counter() - t0)
            if on_logits is not None:
                on_logits(wave, step + 1, logits)
        wave += 1
    return outputs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("serve: no CUDA device (pass --cpu to serve on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.encoder_layers:
        print(f"serve: {cfg.name} is an encoder-decoder model; the CLI serves tokens only "
              "(pass its source to serve(..., src_embeds=...))", file=sys.stderr)
        return 2

    rng = np.random.default_rng(args.seed)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len), dtype=np.int32)

    t_start = time.time()
    outputs = serve(params, cfg, torch.from_numpy(prompts).to(dev), args.batch, args.gen)
    dt = time.time() - t_start
    n_decoded = sum(len(toks) for toks in outputs.values())
    print(f"served {args.requests} requests, {n_decoded} tokens "
          f"in {dt:.2f}s ({n_decoded / dt:.1f} tok/s)")
    for i in range(min(3, args.requests)):
        print(f"request {i}: {outputs[i][:10]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
