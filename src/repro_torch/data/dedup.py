"""Training-data dedup/counting on the BCL containers (DESIGN.md section 3),
the port of ``repro.data.dedup``.

The k-mer counting pipeline re-skinned for LM data: documents hash to
shingle fingerprints (n-gram rolling hashes); a blocked BloomFilter
drops first-seen shingles cheaply, and a DHashMap counts repeated ones.
Documents whose shingles are mostly already-seen are near-duplicates.

Shingles are hashed on the documents' device: the FNV-style roll
``h = h * 1099511628211 ^ tok`` runs in int64, whose wrapping multiply
is the JAX package's ``uint64`` arithmetic mod 2**64, and each hash is
split into ``hi``/``lo`` u32 words (int32 bit-views, as everywhere in
the port).  Verdicts and fractions stay on the device: nothing here
waits on the host.  The module is pure container logic, so it runs on a
``SerialBackend`` or on one rank of a ``ProcessGroupBackend`` (shard the
corpus) unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.containers import bloom as bl
from repro_torch.containers import hashmap as hm
from repro_torch.core.backend import Backend
from repro_torch.core.object_container import Spec
from repro_torch.core.u32 import as_u64, to_i32
from repro_torch.kernels.ops import MODE_ADD

#: the shingle roll's multiplier (the 64-bit FNV prime)
FNV_PRIME = 1099511628211
_U32 = Spec((), torch.uint32)
_KEY = {"hi": _U32, "lo": _U32}


@dataclasses.dataclass(frozen=True)
class DedupSpec:
    ngram: int = 8
    nbits: int = 1 << 22
    table_capacity: int = 1 << 16
    dup_threshold: float = 0.5      # duplicate if > this frac seen before
    max_rounds: int = 1             # exchange carryover retry rounds.
    #                                 Dedup traffic must be lossless, so
    #                                 per-round wire capacity is sized
    #                                 ceil(m / max_rounds): rounds x cap
    #                                 always covers the batch, and R > 1
    #                                 trades extra all-to-all launches
    #                                 for 1/R the per-round wire footprint
    #                                 (the win when shingle hashing skews
    #                                 traffic onto few owner ranks)


class Deduper:
    """Stateful wrapper (host-side) over the bloom+hashmap pair, whose
    state lives on ``device`` (the card unless the caller asks for the
    CPU); ``impl`` picks the kernels (``"auto"``) or the plain versions
    (``"torch"``)."""

    def __init__(self, backend: Backend, spec: DedupSpec = DedupSpec(), device="cuda",
                 impl: str = "auto"):
        self.backend = backend
        self.spec = spec
        self.device = torch.device(device)
        self.bspec, self.bstate = bl.bloom_create(backend, spec.nbits, _KEY, k=4,
                                                  impl=impl, device=device)
        self.hspec, self.hstate = hm.hashmap_create(backend, spec.table_capacity, _KEY,
                                                    _U32, block_size=64, impl=impl,
                                                    device=device)

    def shingles(self, tokens) -> dict:
        """(B, T) token ids (numpy or a tensor) -> rolling n-gram
        fingerprints ``{"hi", "lo"}``, (B, T-n+1) int32 words each."""
        tok = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        n = self.spec.ngram
        m = tok.shape[1] - n + 1
        h = torch.zeros((tok.shape[0], m), dtype=torch.int64, device=self.device)
        for i in range(n):
            h = h * FNV_PRIME ^ tok[:, i:i + m]
        return {"hi": to_i32(h >> 32), "lo": to_i32(h)}

    def _flat_shingles(self, tokens):
        sh = self.shingles(tokens)
        flat = {k: v.reshape(-1) for k, v in sh.items()}
        return flat, sh["hi"].shape[0], sh["hi"].shape[1]

    def _cap(self, m: int) -> int:
        """Per-round wire capacity: rounds x cap >= m keeps every
        exchange lossless while R > 1 shrinks each launch R-fold."""
        return max(1, -(-m // self.spec.max_rounds))

    def _count_seen(self, flat: dict, m: int, seen, b: int, n_sh: int):
        """Shared ingest tail: count repeated shingles, rate the docs.

        Repeated shingles only: the Bloom pre-pass keeps singletons out
        of the count table, the paper's memory win.  Both the eager
        ``observe`` and the fused ``observe_and_probe`` paths must stay
        on this one implementation so their semantics cannot diverge.
        """
        self.hstate, _ = hm.insert(self.backend, self.hspec, self.hstate, flat,
                                   torch.ones(m, dtype=torch.int32, device=self.device),
                                   capacity=self._cap(m), valid=seen, mode=MODE_ADD,
                                   attempts=3, max_rounds=self.spec.max_rounds)
        dup_frac = _mean_rows(seen, b)
        return dup_frac, dup_frac > self.spec.dup_threshold

    def observe(self, tokens):
        """Ingest a batch of documents.

        Returns (dup_frac (B,) float64, is_duplicate (B,) bool) and
        updates the filter + count table.
        """
        flat, b, n_sh = self._flat_shingles(tokens)
        m = b * n_sh
        self.bstate, seen = bl.insert(self.backend, self.bspec, self.bstate, flat,
                                      capacity=self._cap(m),
                                      max_rounds=self.spec.max_rounds)
        return self._count_seen(flat, m, seen, b, n_sh)

    def observe_and_probe(self, tokens, probe_tokens):
        """Ingest ``tokens`` while probing ``probe_tokens`` membership.

        The bloom insert (ingest) and bloom find (probe) are fused into
        one ExchangePlan: one collective round trip for both ops, at
        exactly the sum of the two standalone ops' wire bytes (ragged
        segments, DESIGN.md section 1.5), the contamination-check
        pattern: observe a training batch and test an eval batch
        against the filter in the same round.  The probe observes the
        filter *after* this batch's insertions (identical to the
        ``Promise.FINE`` sequential schedule).

        Returns ``(dup_frac (B,), is_duplicate (B,), probe_seen_frac
        (Bp,))``.
        """
        flat, b, n_sh = self._flat_shingles(tokens)
        flatp, bp, _ = self._flat_shingles(probe_tokens)
        m, mp = b * n_sh, flatp["hi"].shape[0]

        self.bstate, seen, probed = bl.insert_find(
            self.backend, self.bspec, self.bstate, flat, flatp,
            capacity_ins=self._cap(m), capacity_find=self._cap(mp),
            max_rounds=self.spec.max_rounds)
        dup_frac, is_dup = self._count_seen(flat, m, seen, b, n_sh)
        return dup_frac, is_dup, _mean_rows(probed, bp)

    def count_of(self, tokens) -> torch.Tensor:
        """Occurrence counts (beyond first sighting) of a doc's shingles,
        (B, T-n+1) int64."""
        flat, b, _ = self._flat_shingles(tokens)
        m = flat["hi"].shape[0]
        self.hstate, v, found = hm.find(self.backend, self.hspec, self.hstate, flat,
                                        capacity=self._cap(m),
                                        max_rounds=self.spec.max_rounds)
        return torch.where(found, as_u64(v) + 1, 1).reshape(b, -1)


def _mean_rows(flags: torch.Tensor, rows: int) -> torch.Tensor:
    """Each row's share of set flags in float64: the exact count over the
    row length, the bits of numpy's ``mean`` of a bool array."""
    f = flags.reshape(rows, -1)
    return f.sum(dim=1).to(torch.float64) / f.shape[1]
