"""BCL::HashMap, the distributed hash table (paper section 5.1), PyTorch port.

Layout: a logically contiguous array of *blocks* of B buckets,
distributed block-wise across ranks.  A key hashes to a block; the
owner compares it against all B slots of the block (one warp per block
or per query in the CUDA kernels).  When a block fills, a bounded
number of quadratic rehash attempts retry the failed items.

Concurrency promises select the schedule (paper Table 3), as in
``repro.containers.hashmap``: fully atomic ops run the read-bit dance
on the owner's status words (net zero, so only its traffic is real);
the default 2-attempt find issues both probes as two flows of ONE
ExchangePlan; ``find_insert`` fuses a find batch and an insert batch
into one plan.

State tensors live on the device ``hashmap_create`` is given (the card
by default); every op follows its tensors' device.  Every op returns a
new state: the kernels work on copies, as the JAX functions are pure.
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
from repro_torch.core.promises import (Promise, find_only, fine_grained,
                                       fully_atomic_hashmap, local_only, validate)
from repro_torch.core.u32 import M32, to_i32
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64

# a "read bit" in the upper 30 bits of the status word (paper 5.1.2)
_READ_BIT = 1 << 7


@dataclasses.dataclass(frozen=True)
class HashMapSpec:
    nblocks_global: int
    nblocks_local: int
    block_size: int
    key_packer: Packer
    val_packer: Packer
    impl: str = "auto"   # kernel dispatch: auto|torch|cuda

    @property
    def capacity(self) -> int:
        return self.nblocks_global * self.block_size


class HashMapState(NamedTuple):
    tkeys: torch.Tensor    # (nb_local, B, Lk) int32 words
    tvals: torch.Tensor    # (nb_local, B, Lv) int32 words
    status: torch.Tensor   # (nb_local, B) int32 words


def hashmap_create(backend: Backend, capacity: int, key_spec, val_spec,
                   block_size: int = 128, impl: str = "auto",
                   device="cuda") -> tuple[HashMapSpec, HashMapState]:
    """Collective constructor (paper 5.1.1): fixed size, fixed K/V types.

    The state lives on ``device``: the card unless the caller asks for
    the CPU.
    """
    kp, vp = packer_for(key_spec), packer_for(val_spec)
    nprocs = backend.nprocs()
    nb_global = max(1, -(-capacity // block_size))
    nb_global = -(-nb_global // nprocs) * nprocs       # round up to P
    nb_local = nb_global // nprocs
    spec = HashMapSpec(nb_global, nb_local, block_size, kp, vp, impl)
    state = HashMapState(
        torch.zeros((nb_local, block_size, kp.lanes), dtype=_I32, device=device),
        torch.zeros((nb_local, block_size, vp.lanes), dtype=_I32, device=device),
        torch.zeros((nb_local, block_size), dtype=_I32, device=device))
    return spec, state


def _block_of(spec: HashMapSpec, key_lanes: torch.Tensor, attempt: int) -> torch.Tensor:
    """Global block index; attempts rehash quadratically (paper 5.1)."""
    g = hash_lanes_u64(key_lanes, seed=1)
    if attempt:
        h2 = hash_lanes_u64(key_lanes, seed=3) | 1
        g = (g + (attempt * attempt) * h2) & M32
    return (g % spec.nblocks_global).to(_I32)


def _owner_local(spec: HashMapSpec, gblock: torch.Tensor):
    return gblock // spec.nblocks_local, gblock % spec.nblocks_local


def _read_bits(st: torch.Tensor, rblock: torch.Tensor, sign: int) -> torch.Tensor:
    """Add ``sign * READ_BIT`` to every status word of each listed block,
    once per listing (wrapping u32), like ``st.at[rb].add`` in JAX."""
    per_block = torch.bincount(rblock.to(_I64), minlength=st.shape[0])
    delta = (per_block * (sign * _READ_BIT)) & M32
    return to_i32(st.to(_I64) + delta[:, None])


def _arrival_blocks(res) -> torch.Tensor:
    return torch.where(res.valid, res.payload[:, 0], 0)


def insert(backend: Backend, spec: HashMapSpec, state: HashMapState,
           keys, vals, capacity: int,
           promise: Promise = Promise.FIND | Promise.INSERT,
           valid: torch.Tensor | None = None,
           mode: int = kops.MODE_SET,
           attempts: int = 2,
           return_success: bool = True,
           max_rounds: int = 1,
           transport=None,
           dead_ranks=None,
           integrity: bool = False):
    """Insert a batch of (key, value) pairs.

    Returns (state, success(N,) | None).  With ``promise=local`` the keys
    must hash to this rank's own blocks (cost l, no collectives).
    ``max_rounds`` adds carryover retry rounds to each exchange.
    """
    validate(promise)
    klanes = spec.key_packer.pack(keys)
    vlanes = spec.val_packer.pack(vals)
    n = klanes.shape[0]
    dev = klanes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)

    if local_only(promise):
        _, lblock = _owner_local(spec, _block_of(spec, klanes, 0))
        tk, tv, st, ok = kops.bulk_insert(
            state.tkeys, state.tvals, state.status, lblock, klanes, vlanes,
            valid, mode, impl=spec.impl)
        costs.record("hashmap.insert", costs.Cost(local=n))
        return HashMapState(tk, tv, st), ok

    atomic = fully_atomic_hashmap(promise)
    pending = valid
    success = torch.zeros(n, dtype=torch.bool, device=dev)
    new_state = state
    rl = 1 if (return_success or attempts > 1) else 0
    for a in range(max(1, attempts)):
        owner, lblock = _owner_local(spec, _block_of(spec, klanes, a))
        body = torch.cat([lblock[:, None], klanes, vlanes], dim=1)
        plan = ExchangePlan(name="hashmap.insert")
        h = plan.add(body, owner, capacity, reply_lanes=rl, valid=pending,
                     op_name="hashmap.insert")
        c = plan.commit(backend, impl=spec.impl, max_rounds=max_rounds,
                        transport=transport, dead_ranks=dead_ranks,
                        integrity=integrity)
        res = c.view(h)

        tk, tv, st = new_state
        if atomic:
            # paper 5.1.3: the reserve pass, a net-zero RMW on the status
            # word of every touched block
            rb = _arrival_blocks(res)
            st = _read_bits(_read_bits(st, rb, 1), rb, -1)
        tk, tv, st, ok_here = kops.bulk_insert_arrivals(
            tk, tv, st, res.payload, res.valid, mode, impl=spec.impl)
        new_state = HashMapState(tk, tv, st)

        if rl:
            c.set_reply(h, ok_here.to(_I32))
            back, _ = c.finish(backend)[h]
            ok_src = (back[:, 0] == 1) & pending
            success = success | ok_src
            pending = pending & ~ok_src
        else:
            break
    costs.record("hashmap.insert", costs.Cost(A=2 if atomic else 1, W=n))
    return new_state, (success if (return_success or attempts > 1) else None)


def _probe(state: HashMapState, res_payload, res_valid, atomic: bool, impl: str):
    """Owner-side find over an arrival segment (+ the read-bit dance).

    Returns (state, reply rows [value lanes | found]).
    """
    tk, tv, st = state
    if atomic:
        rb = torch.where(res_valid, res_payload[:, 0], 0)
        st = _read_bits(st, rb, 1)
    found_here, vlanes = kops.bulk_find_arrivals(tk, tv, st, res_payload, res_valid,
                                                 impl=impl)
    if atomic:
        st = _read_bits(st, rb, -1)
        state = HashMapState(tk, tv, st)
    return state, torch.cat([vlanes, found_here.to(_I32)[:, None]], dim=1)


def _find_speculative(backend: Backend, spec: HashMapSpec, state: HashMapState,
                      klanes, capacity: int, valid, atomic: bool,
                      max_rounds: int = 1, transport=None, dead_ranks=None,
                      integrity: bool = False):
    """Dual-attempt find in ONE round trip (2 collectives, not 4).

    Both probe attempts are two flows of one ExchangePlan; the requester
    prefers the attempt-0 answer, which equals the sequential attempt
    loop whenever the capacity admits every request.
    """
    n = klanes.shape[0]
    owner0, lb0 = _owner_local(spec, _block_of(spec, klanes, 0))
    owner1, lb1 = _owner_local(spec, _block_of(spec, klanes, 1))
    rl = spec.val_packer.lanes + 1
    plan = ExchangePlan(name="hashmap.find")
    h0 = plan.add(torch.cat([lb0[:, None], klanes], dim=1), owner0, capacity,
                  reply_lanes=rl, valid=valid, op_name="hashmap.find")
    h1 = plan.add(torch.cat([lb1[:, None], klanes], dim=1), owner1, capacity,
                  reply_lanes=rl, valid=valid, op_name="hashmap.find")
    c = plan.commit(backend, impl=spec.impl, max_rounds=max_rounds,
                    transport=transport, dead_ranks=dead_ranks, integrity=integrity)
    v0, v1 = c.view(h0), c.view(h1)

    seg = torch.cat([v0.payload, v1.payload])
    rvalid = torch.cat([v0.valid, v1.valid])
    state, body_back = _probe(state, seg, rvalid, atomic, spec.impl)
    m = v0.payload.shape[0]
    c.set_reply(h0, body_back[:m])
    c.set_reply(h1, body_back[m:])
    outs = c.finish(backend)
    b0, _ = outs[h0]
    b1, _ = outs[h1]
    got0 = (b0[:, -1] == 1) & valid
    got1 = (b1[:, -1] == 1) & valid
    found = got0 | got1
    vals = torch.where(got0[:, None], b0[:, :-1], b1[:, :-1])
    vals = torch.where(found[:, None], vals, 0)
    costs.record("hashmap.find", costs.Cost(A=2 if atomic else 0, R=n))
    return state, spec.val_packer.unpack(vals), found


def find(backend: Backend, spec: HashMapSpec, state: HashMapState,
         keys, capacity: int,
         promise: Promise = Promise.FIND | Promise.INSERT,
         valid: torch.Tensor | None = None,
         attempts: int = 2,
         speculative: bool = True,
         max_rounds: int = 1,
         transport=None,
         dead_ranks=None,
         integrity: bool = False):
    """Find a batch of keys. Returns (state, values, found(N,)).

    With ``speculative`` (the default) a 2-attempt find issues both probe
    attempts as two flows of one ExchangePlan; ``speculative=False`` is
    the sequential attempt loop.  ``Promise.FINE`` forces the loop.
    """
    validate(promise)
    if fine_grained(promise):
        speculative = False
    klanes = spec.key_packer.pack(keys)
    n = klanes.shape[0]
    dev = klanes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)

    if local_only(promise):
        _, lblock = _owner_local(spec, _block_of(spec, klanes, 0))
        found, vlanes = kops.bulk_find(state.tkeys, state.tvals, state.status,
                                       lblock, klanes, valid, impl=spec.impl)
        costs.record("hashmap.find", costs.Cost(local=n))
        return state, spec.val_packer.unpack(vlanes), found

    atomic = not find_only(promise)
    if speculative and attempts == 2:
        return _find_speculative(backend, spec, state, klanes, capacity, valid,
                                 atomic, max_rounds=max_rounds, transport=transport,
                                 dead_ranks=dead_ranks, integrity=integrity)
    pending = valid
    found_all = torch.zeros(n, dtype=torch.bool, device=dev)
    vals_all = torch.zeros((n, spec.val_packer.lanes), dtype=_I32, device=dev)
    for a in range(max(1, attempts)):
        owner, lblock = _owner_local(spec, _block_of(spec, klanes, a))
        plan = ExchangePlan(name="hashmap.find")
        h = plan.add(torch.cat([lblock[:, None], klanes], dim=1), owner, capacity,
                     reply_lanes=spec.val_packer.lanes + 1, valid=pending,
                     op_name="hashmap.find")
        c = plan.commit(backend, impl=spec.impl, max_rounds=max_rounds,
                        transport=transport, dead_ranks=dead_ranks,
                        integrity=integrity)
        res = c.view(h)
        state, body_back = _probe(state, res.payload, res.valid, atomic, spec.impl)
        c.set_reply(h, body_back)
        back, _ = c.finish(backend)[h]
        got = (back[:, -1] == 1) & pending
        vals_all = torch.where(got[:, None], back[:, :-1], vals_all)
        found_all = found_all | got
        pending = pending & ~got
        if attempts == 1:
            break
    costs.record("hashmap.find", costs.Cost(A=2 if atomic else 0, R=n))
    return state, spec.val_packer.unpack(vals_all), found_all


def find_insert(backend: Backend, spec: HashMapSpec, state: HashMapState,
                find_keys, ins_keys, ins_vals, capacity: int,
                promise: Promise = Promise.FIND | Promise.INSERT,
                find_valid: torch.Tensor | None = None,
                ins_valid: torch.Tensor | None = None,
                mode: int = kops.MODE_SET,
                max_rounds: int = 1,
                transport=None,
                dead_ranks=None,
                integrity: bool = False,
                async_: bool = False):
    """Fused find + insert sharing ONE exchange round trip.

    Finds observe the table as it was before this batch's insertions;
    both ops' flows ride one ExchangePlan (2 collectives where the
    ``Promise.FINE`` sequential schedule costs 4).  Both probes use
    attempt 0.  Returns ``(state, values, found, ins_ok)``.

    ``async_=True`` commits the plan split-phase and returns a
    :class:`~repro_torch.core.PendingResult` whose ``finish()`` gives the
    same 4-tuple; the request wire is in flight when the call returns.
    """
    validate(promise)
    find_atomic = not find_only(promise)
    ins_atomic = fully_atomic_hashmap(promise)
    kw = dict(max_rounds=max_rounds, transport=transport, dead_ranks=dead_ranks,
              integrity=integrity)
    if fine_grained(promise):
        state, vals, found = find(backend, spec, state, find_keys, capacity,
                                  promise=promise, valid=find_valid, attempts=1, **kw)
        state, ok = insert(backend, spec, state, ins_keys, ins_vals, capacity,
                           promise=promise, valid=ins_valid, mode=mode, attempts=1,
                           return_success=True, **kw)
        # split-phase FINE stays the sequential oracle: run eagerly
        out = (state, vals, found, ok)
        return PendingResult(lambda: out) if async_ else out

    kf = spec.key_packer.pack(find_keys)
    ki = spec.key_packer.pack(ins_keys)
    vi = spec.val_packer.pack(ins_vals)
    nf, ni = kf.shape[0], ki.shape[0]
    dev = kf.device
    if find_valid is None:
        find_valid = torch.ones(nf, dtype=torch.bool, device=dev)
    if ins_valid is None:
        ins_valid = torch.ones(ni, dtype=torch.bool, device=dev)
    owner_f, lb_f = _owner_local(spec, _block_of(spec, kf, 0))
    owner_i, lb_i = _owner_local(spec, _block_of(spec, ki, 0))

    plan = ExchangePlan(name="hashmap.find_insert")
    hf = plan.add(torch.cat([lb_f[:, None], kf], dim=1), owner_f, capacity,
                  reply_lanes=spec.val_packer.lanes + 1, valid=find_valid,
                  op_name="hashmap.find")
    hi = plan.add(torch.cat([lb_i[:, None], ki, vi], dim=1), owner_i, capacity,
                  reply_lanes=1, valid=ins_valid, op_name="hashmap.insert")

    def complete(c):
        return _find_insert_complete(backend, spec, state, c, hf, hi, find_valid,
                                     ins_valid, mode, find_atomic, ins_atomic, nf, ni)

    if async_:
        pend = plan.commit_async(backend, impl=spec.impl, **kw)
        return PendingResult(lambda: complete(pend.finish(backend)))
    return complete(plan.commit(backend, impl=spec.impl, **kw))


def _find_insert_complete(backend, spec, state, c, hf, hi, find_valid, ins_valid, mode,
                          find_atomic, ins_atomic, nf, ni):
    """Owner-side work + reply round of :func:`find_insert` (the sync and
    the split-phase path both complete here)."""
    vf, vw = c.view(hf), c.view(hi)

    # find against the pre-insert table, then insert (same reserve pass
    # as the standalone op)
    state, find_back = _probe(state, vf.payload, vf.valid, find_atomic, spec.impl)
    tk, tv, st = state
    if ins_atomic:
        rb_i = _arrival_blocks(vw)
        st = _read_bits(_read_bits(st, rb_i, 1), rb_i, -1)
    tk, tv, st, ok_here = kops.bulk_insert_arrivals(tk, tv, st, vw.payload, vw.valid,
                                                    mode, impl=spec.impl)
    state = HashMapState(tk, tv, st)

    c.set_reply(hf, find_back)
    c.set_reply(hi, ok_here.to(_I32))
    outs = c.finish(backend)
    bf, _ = outs[hf]
    bi, _ = outs[hi]
    found = (bf[:, -1] == 1) & find_valid
    vals = torch.where(found[:, None], bf[:, :-1], 0)
    ok = (bi[:, 0] == 1) & ins_valid
    costs.record("hashmap.find", costs.Cost(A=2 if find_atomic else 0, R=nf))
    costs.record("hashmap.insert", costs.Cost(A=2 if ins_atomic else 1, W=ni))
    return state, spec.val_packer.unpack(vals), found, ok


def count_ready(backend: Backend, state: HashMapState) -> torch.Tensor:
    """Global number of occupied buckets."""
    ready = (kops.bucket_state(state.status) == kops.READY).sum()
    return backend.psum(ready)


def local_entries(spec: HashMapSpec, state: HashMapState):
    """This rank's (keys, vals, occupied), flattened."""
    nb, b = state.status.shape
    occ = (kops.bucket_state(state.status) == kops.READY).reshape(-1)
    keys = spec.key_packer.unpack(state.tkeys.reshape(nb * b, -1))
    vals = spec.val_packer.unpack(state.tvals.reshape(nb * b, -1))
    return keys, vals, occ


def export_state(spec: HashMapSpec, state: HashMapState) -> dict:
    """This rank's table shard as a plain dict of int32-word tensors."""
    return {"tkeys": state.tkeys, "tvals": state.tvals, "status": state.status}


def restore_state(spec: HashMapSpec, exported: dict, device=None) -> HashMapState:
    """Rebuild a HashMapState shard from :func:`export_state` output."""
    tk = exported["tkeys"]
    want = (spec.nblocks_local, spec.block_size, spec.key_packer.lanes)
    if tuple(tk.shape) != want:
        raise ValueError(f"hashmap.restore_state: tkeys shape {tuple(tk.shape)} "
                         f"does not match spec {want}")
    device = tk.device if device is None else device
    words = [exported[k] for k in ("tkeys", "tvals", "status")]
    return HashMapState(*(w.view(_I32) if w.dtype == torch.uint32 else w.to(_I32)
                          for w in (t.to(device) for t in words)))


def resize(backend: Backend, spec: HashMapSpec, state: HashMapState,
           new_capacity: int, capacity_per_pair: int):
    """Collective resize (paper 5.1.5): rebuild and re-insert all entries."""
    backend.barrier()
    new_spec, new_state = hashmap_create(
        backend, new_capacity, spec.key_packer, spec.val_packer, spec.block_size,
        spec.impl, device=state.status.device)
    keys, vals, occ = local_entries(spec, state)
    new_state, _ = insert(backend, new_spec, new_state, keys, vals,
                          capacity_per_pair, valid=occ, promise=Promise.INSERT,
                          attempts=3)
    costs.record("hashmap.resize", costs.Cost(B=1, W=int(occ.shape[0])))
    return new_spec, new_state
