"""Deterministic synthetic LM data pipeline (the port of ``repro.data.tokens``).

Design requirements from DESIGN.md section 5 (fault tolerance):
  * the stream is a pure function of (seed, step, shard): restart or
    elastic rescale reproduces exactly the same global batch sequence;
  * state is one integer (step), checkpointed alongside the model;
  * host-side numpy generation with per-step prefetch, zero file deps.

Generation stays numpy (``Generator`` over ``SeedSequence([seed, step,
row])``), so a seed gives the same tokens in both packages; batches come
back as torch tensors on the ``device`` asked for, the card by default.

"Documents" are Zipf-ish token runs with markov structure so the LM
loss actually decreases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _on(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        self.seed = int(d["seed"])

    def next_batch(self, n_shards: int = 1, shard: int = 0, device="cuda") -> dict:
        """This shard's slice of the global batch for this step: int32
        ``tokens`` (per, seq_len + 1) and a float32 ``loss_mask``."""
        if self.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        per = self.global_batch // n_shards
        rows = [self._row(self.step, shard * per + i) for i in range(per)]
        self.step += 1
        return _on({"tokens": np.stack(rows),
                    "loss_mask": np.ones((per, self.seq_len), np.float32)}, device)

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        t = self.seq_len + 1
        out = np.empty((t,), np.int32)
        # markov-ish: each doc has a topic offset; tokens cluster near it
        pos = 0
        while pos < t:
            doc_len = int(rng.integers(64, 512))
            topic = int(rng.integers(0, max(self.vocab - 256, 1)))
            base = rng.zipf(1.5, size=doc_len).clip(1, 256) - 1
            seq = (topic + base) % self.vocab
            # first-order structure: even positions echo predecessor
            seq[1::2] = (seq[:-1:2] + 1) % self.vocab
            take = min(doc_len, t - pos)
            out[pos:pos + take] = seq[:take]
            pos += take
        return out


def synth_batch(cfg, shape, rng: np.random.Generator, batch_override=None,
                device="cuda") -> dict:
    """One materialized batch of ``shape`` (a
    :class:`~repro_torch.configs.shapes.ShapeSpec`) for ``cfg``, drawn
    from ``rng`` as the JAX package draws it, as tensors on ``device``."""
    b = batch_override or shape.global_batch
    t = shape.seq_len
    d = cfg.d_model
    out = {}
    if shape.kind == "train":
        if cfg.frontend == "patch":
            n_txt = t - cfg.frontend_len
            out["tokens"] = rng.integers(0, cfg.vocab, (b, n_txt + 1), dtype=np.int32)
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.frontend_len, d), dtype=np.float32)
            out["loss_mask"] = np.ones((b, n_txt), np.float32)
        else:
            out["tokens"] = rng.integers(0, cfg.vocab, (b, t + 1), dtype=np.int32)
            out["loss_mask"] = np.ones((b, t), np.float32)
            if cfg.frontend == "frame":
                out["src_embeds"] = rng.standard_normal(
                    (b, max(t // 4, 8), d), dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, t), dtype=np.int32)
        if cfg.frontend == "patch":
            out["tokens"] = out["tokens"][:, :t - cfg.frontend_len]
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.frontend_len, d), dtype=np.float32)
        if cfg.frontend == "frame":
            out["src_embeds"] = rng.standard_normal(
                (b, max(t // 4, 8), d), dtype=np.float32)
    return _on(out, device)
