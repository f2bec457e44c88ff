"""BCL::BloomFilter, a distributed *blocked* Bloom filter (paper 5.4.2),
PyTorch port.

A value hashes to one 64-bit block; k bit positions inside that block
come from double hashing (``ops.hash_words``: the ``hash_words`` CUDA
kernel on the card).  Insertion is one owner-side read-modify-write of
the block word, and it returns whether the value was already present,
also among duplicates within one batch, where exactly the first
inserter (in deterministic arrival order) observes "not present"
(``ops.bloom_insert``: a segmented OR-scan plus the ``membership``
kernel on the card).

Cost model (paper Table 2): insert = A, find = R.  ``insert_find`` fuses
an insert batch and a query batch into one ExchangePlan round trip;
``Promise.FINE`` recovers the sequential schedule; ``async_=True``
commits it split-phase.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.exchange import ExchangePlan, PendingResult
from repro_torch.core.hashing import hash_lanes_u64
from repro_torch.core.object_container import Packer, packer_for
from repro_torch.core.promises import Promise, fine_grained, validate
from repro_torch.core.u32 import as_u64
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class BloomSpec:
    nblocks_global: int
    nblocks_local: int
    k: int
    packer: Packer
    impl: str = "auto"


class BloomState(NamedTuple):
    words: torch.Tensor   # (nb_local, 2) int32 words: one 64-bit block per row


def bloom_create(backend: Backend, nbits: int, value_spec, k: int = 4,
                 impl: str = "auto", device="cuda") -> tuple[BloomSpec, BloomState]:
    """Collective constructor; the filter lives on ``device``."""
    packer = packer_for(value_spec)
    nprocs = backend.nprocs()
    nb_global = max(1, -(-nbits // 64))
    nb_global = -(-nb_global // nprocs) * nprocs
    nb_local = nb_global // nprocs
    spec = BloomSpec(nb_global, nb_local, k, packer, impl)
    return spec, BloomState(torch.zeros((nb_local, 2), dtype=_I32, device=device))


def _words_of(spec: BloomSpec, items, valid):
    """Pack items into the wire body ``[local block | 2 bit-words]``."""
    lanes = spec.packer.pack(items)
    n = lanes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=lanes.device)
    gblock = (hash_lanes_u64(lanes, seed=11) % spec.nblocks_global).to(_I32)
    owner = gblock // spec.nblocks_local
    lblock = gblock % spec.nblocks_local
    words = kops.hash_words(lanes, spec.k, impl=spec.impl)
    return n, torch.cat([lblock[:, None], words], dim=1), owner, valid


def _owner_rows(view):
    """Arrived ``(local block, bit-words)``; invalid rows read block 0."""
    return torch.where(view.valid, view.payload[:, 0], 0), view.payload[:, 1:3]


def _route_words(backend: Backend, spec: BloomSpec, items, valid, capacity,
                 op_name: str, max_rounds: int = 1, transport=None):
    """Single-flow plan shipping ``[lblock | bit-words]`` rows with a
    1-word answer reply."""
    n, body, owner, valid = _words_of(spec, items, valid)
    plan = ExchangePlan(name=op_name)
    h = plan.add(body, owner, capacity, reply_lanes=1, valid=valid, op_name=op_name)
    c = plan.commit(backend, impl=spec.impl, max_rounds=max_rounds, transport=transport)
    return n, c, h, c.view(h)


def insert(backend: Backend, spec: BloomSpec, state: BloomState, items, capacity: int,
           valid: torch.Tensor | None = None, max_rounds: int = 1, transport=None):
    """Atomic insert; returns (state, already_present(N,)).

    ``already_present[i]`` is True iff every one of item i's k bits was
    set before item i's own insertion (first-inserter-wins, within the
    batch too).
    """
    n, c, h, res = _route_words(backend, spec, items, valid, capacity, "bloom.insert",
                                max_rounds=max_rounds, transport=transport)
    rb, rw = _owner_rows(res)
    words, already = kops.bloom_insert(state.words, rb, rw, res.valid, impl=spec.impl)
    c.set_reply(h, already.to(_I32))
    back, _ = c.finish(backend)[h]
    costs.record("bloom.insert", costs.Cost(A=1))
    return BloomState(words), back[:, 0] == 1


def find(backend: Backend, spec: BloomSpec, state: BloomState, items, capacity: int,
         valid: torch.Tensor | None = None, max_rounds: int = 1, transport=None):
    """Membership query; returns present(N,). Cost R."""
    n, c, h, res = _route_words(backend, spec, items, valid, capacity, "bloom.find",
                                max_rounds=max_rounds, transport=transport)
    rb, rw = _owner_rows(res)
    present = kops.bloom_find(state.words, rb, rw, res.valid, impl=spec.impl)
    c.set_reply(h, present.to(_I32))
    back, _ = c.finish(backend)[h]
    costs.record("bloom.find", costs.Cost(R=n))
    return back[:, 0] == 1


def insert_find(backend: Backend, spec: BloomSpec, state: BloomState,
                ins_items, find_items, capacity_ins: int, capacity_find: int,
                ins_valid: torch.Tensor | None = None,
                find_valid: torch.Tensor | None = None,
                promise: Promise = Promise.NONE, max_rounds: int = 1,
                transport=None, async_: bool = False):
    """Fused insert + membership query sharing ONE exchange round trip.

    The insert is serialized before the find, so the query observes this
    batch's insertions (the ``Promise.FINE`` sequential order).  Returns
    ``(state, already_present, present)``; ``async_=True`` commits the
    plan split-phase and returns a :class:`~repro_torch.core.PendingResult`
    whose ``finish()`` gives the same triple.
    """
    validate(promise)
    if fine_grained(promise):
        st, already = insert(backend, spec, state, ins_items, capacity_ins,
                             valid=ins_valid, max_rounds=max_rounds, transport=transport)
        present = find(backend, spec, st, find_items, capacity_find, valid=find_valid,
                       max_rounds=max_rounds, transport=transport)
        # split-phase FINE stays the sequential oracle: run eagerly
        out = (st, already, present)
        return PendingResult(lambda: out) if async_ else out

    _, body_i, owner_i, ins_valid = _words_of(spec, ins_items, ins_valid)
    nf, body_f, owner_f, find_valid = _words_of(spec, find_items, find_valid)
    plan = ExchangePlan(name="bloom.insert_find")
    hi = plan.add(body_i, owner_i, capacity_ins, reply_lanes=1, valid=ins_valid,
                  op_name="bloom.insert")
    hf = plan.add(body_f, owner_f, capacity_find, reply_lanes=1, valid=find_valid,
                  op_name="bloom.find")
    if async_:
        pend = plan.commit_async(backend, impl=spec.impl, max_rounds=max_rounds,
                                 transport=transport)
        return PendingResult(lambda: _insert_find_complete(
            backend, spec, state, pend.finish(backend), hi, hf, nf))
    c = plan.commit(backend, impl=spec.impl, max_rounds=max_rounds, transport=transport)
    return _insert_find_complete(backend, spec, state, c, hi, hf, nf)


def _insert_find_complete(backend, spec, state, c, hi, hf, nf):
    """Owner-side work + reply round of :func:`insert_find` (the sync and
    the split-phase path both complete here)."""
    vi, vf = c.view(hi), c.view(hf)
    rb_i, rw_i = _owner_rows(vi)
    words, already = kops.bloom_insert(state.words, rb_i, rw_i, vi.valid, impl=spec.impl)
    rb_f, rw_f = _owner_rows(vf)
    present = kops.bloom_find(words, rb_f, rw_f, vf.valid, impl=spec.impl)
    c.set_reply(hi, already.to(_I32))
    c.set_reply(hf, present.to(_I32))
    outs = c.finish(backend)
    bi, _ = outs[hi]
    bf, _ = outs[hf]
    costs.record("bloom.insert", costs.Cost(A=1))
    costs.record("bloom.find", costs.Cost(R=nf))
    return BloomState(words), bi[:, 0] == 1, bf[:, 0] == 1


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 word (SWAR in int64: torch has no int32 popcount)."""
    x = as_u64(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def fill_fraction(backend: Backend, state: BloomState) -> torch.Tensor:
    """Fraction of set bits (diagnostic for false-positive estimation);
    a float32 scalar.  The bits are counted in int64, so a filter of
    2**31 bits or more a rank counts right; below that the quotient is
    the JAX package's int32 one."""
    tot = backend.psum(_popcount32(state.words).sum())
    nbits = backend.psum(torch.tensor(state.words.numel() * 32, dtype=torch.int64,
                                      device=state.words.device))
    return tot.to(torch.float32) / nbits.to(torch.float32)
