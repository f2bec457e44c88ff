"""Owner-side hash probe kernels: ``insert_arrivals`` and ``find_arrivals``.

Each wrapper launches its hand-written CUDA kernel
(``csrc/hash_probe.cu``) on CUDA tensors and takes its plain PyTorch
version only for CPU tensors.  The plain versions are the JAX package's
vectorized jnp paths (``repro/kernels/ops.py:72-223``), bit for bit.

``seg`` is the exchange's owner view of an arrival segment: rows of
[local block | key lanes | value lanes]; its rows may be strided (a
column slice of the wire segment), its words must be contiguous.

Neither kernel has a per-block query capacity: the JAX package's Pallas
kernels fail (insert) or re-probe (find) arrivals past ``q_cap``, the
port serves every arrival, as the jnp path does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.u32 import as_u64, to_i32
from repro_torch.kernels.binning import require
from repro_torch.kernels.build import Kernel, register
from repro_torch.kernels.ref import (FREE, MODE_ADD, MODE_KEEP, MODE_SET,
                                     READY, STATE_MASK, bucket_state,
                                     hash_probe_find_ref)

_I32 = torch.int32
_I64 = torch.int64
_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: key and value lanes the kernels serve (one lane per warp thread)
MAX_LANES = 32

_INSERT = register("insert_arrivals", Kernel(
    "hash_probe", "insert_arrivals_launch",
    [_P, _P, _P, _P, _LL, _P, _P, _LL, _INT, _INT, _INT, _INT, _P]))
_FIND = register("find_arrivals", Kernel(
    "hash_probe", "find_arrivals_launch",
    [_P, _P, _P, _P, _LL, _P, _LL, _LL, _INT, _INT, _INT, _P, _P]))


def bin_queries(qblock: torch.Tensor, valid: torch.Tensor, nb: int):
    """CSR of arrivals by local block: ``(order (M,), start (nb+1,))``.

    ``order[start[b]:start[b+1]]`` are block b's valid arrivals in batch
    order (a stable sort), as ``repro/kernels/hash_probe.py:49-67``
    bins them outside its kernel.
    """
    b = torch.where(valid, qblock.to(_I64), nb)
    counts = torch.bincount(b, minlength=nb + 1)
    start = torch.zeros(nb + 1, dtype=_I64, device=qblock.device)
    start[1:] = torch.cumsum(counts[:nb], 0)
    order = torch.argsort(b, stable=True)
    return order.to(_I32), start.to(_I32)


def _check_table(tkeys, tvals, status, seg, valid, what: str, seg_lanes: int):
    nb, bsz, lk = tkeys.shape
    lv = tvals.shape[2]
    dev = tkeys.device
    require(tkeys, f"{what} tkeys", _I32, (nb, bsz, lk), dev)
    require(tvals, f"{what} tvals", _I32, (nb, bsz, lv), dev)
    require(status, f"{what} status", _I32, (nb, bsz), dev)
    m = seg.shape[0]
    require(valid, f"{what} valid", torch.bool, (m,), dev)
    if (seg.dtype != _I32 or seg.device != dev or seg.ndim != 2
            or seg.shape[1] < seg_lanes or seg.stride(1) != 1):
        raise ValueError(f"{what} seg: want int32 rows of >= {seg_lanes} "
                         f"contiguous words on {dev}, got {seg.dtype} "
                         f"{tuple(seg.shape)} strides {seg.stride()} on {seg.device}")
    if lk > MAX_LANES or lv > MAX_LANES:
        raise ValueError(f"{what}: {lk} key / {lv} value lanes; the kernel "
                         f"serves at most {MAX_LANES}")
    return nb, bsz, lk, lv, m


# --------------------------------------------------------------------------
# insert
# --------------------------------------------------------------------------

def _lexsort_items(qblock, qkeys, qvalid, nb):
    """Stable order grouping items by (block, key lanes); invalid last.

    Sorts by the unsigned key values, as ``jnp.lexsort`` does on u32.
    """
    b = torch.where(qvalid, qblock.to(_I64), nb)
    order = torch.arange(b.shape[0], device=b.device)
    for key in [as_u64(qkeys[:, i]) for i in range(qkeys.shape[1] - 1, -1, -1)] + [b]:
        order = order[torch.argsort(key[order], stable=True)]
    return order, b[order]


def bulk_insert_plain(tkeys, tvals, status, qblock, qkeys, qvals, qvalid,
                      mode: int = MODE_SET):
    """Vectorized blocked insert (``repro/kernels/ops.py:72-176``).

    Equal to the sequential oracle for any batch, duplicate keys
    included (SET keeps the last duplicate's value, ADD sums, KEEP keeps
    the first).  Returns new (tkeys, tvals, status, success(M,)).
    """
    nb, bsz, _ = tkeys.shape
    m = qblock.shape[0]
    lv = qvals.shape[1]
    dev = tkeys.device

    order, sb = _lexsort_items(qblock, qkeys, qvalid, nb)
    sk, sv, svalid = qkeys[order], qvals[order], qvalid[order]
    idx = torch.arange(m, device=dev)

    prev_same = torch.zeros(m, dtype=torch.bool, device=dev)
    prev_same[1:] = (sb[1:] == sb[:-1]) & (sk[1:] == sk[:-1]).all(dim=1)
    is_leader = svalid & ~prev_same
    group_id = (torch.cumsum(is_leader.to(_I64), 0) - 1).clamp(min=0)

    # combine duplicate values per group, honoring batch order
    if mode == MODE_SET:     # last duplicate wins
        last_pos = torch.full((m,), -1, dtype=_I64, device=dev).scatter_reduce(
            0, group_id, torch.where(svalid, idx, -1), "amax")
        gval = sv[last_pos.clamp(min=0)]
    else:                    # ADD sums every duplicate; KEEP takes the leader's
        take = svalid if mode == MODE_ADD else is_leader & svalid
        gval = to_i32(torch.zeros((m, lv), dtype=_I64, device=dev).index_add_(
            0, group_id, torch.where(take[:, None], as_u64(sv), 0)))
    leader_val = gval[group_id]

    # probe each leader's block
    blk = sb % nb
    match = ((tkeys[blk] == sk[:, None, :]).all(dim=2)
             & (bucket_state(status[blk]) == READY))
    found = match.any(dim=1) & is_leader
    mslot = torch.argmax(match.to(torch.uint8), dim=1)

    # free-slot ranking per block
    free_mask = bucket_state(status) == FREE
    free_order = torch.argsort((~free_mask).to(torch.uint8), dim=1, stable=True)
    nfree = free_mask.sum(dim=1)

    # rank each new leader within its block by ORIGINAL batch position, so
    # free slots are claimed in the order the sequential oracle claims them
    new_leader = is_leader & ~found
    k_pos = torch.where(new_leader, order, m)
    k_blk = torch.where(new_leader, sb, nb)
    ord2 = torch.argsort(k_blk * (m + 1) + k_pos, stable=True)
    nl2 = new_leader[ord2].to(_I64)
    sb2 = torch.where(nl2 == 1, sb[ord2], nb)
    blk_change2 = torch.ones(m, dtype=torch.bool, device=dev)
    blk_change2[1:] = sb2[1:] != sb2[:-1]
    seg2 = torch.cumsum(blk_change2.to(_I64), 0) - 1
    ex2 = torch.cumsum(nl2, 0) - nl2
    base2 = torch.zeros(m, dtype=_I64, device=dev).index_add_(
        0, seg2, torch.where(blk_change2, ex2, 0))
    r = torch.empty(m, dtype=_I64, device=dev)
    r[ord2] = ex2 - base2[seg2]

    sb_c = sb.clamp(0, nb - 1)
    has_room = r < nfree[sb_c]
    slot_new = free_order[sb_c, r.clamp(0, bsz - 1)]
    slot = torch.where(found, mslot, slot_new)
    ok_leader = is_leader & (found | (new_leader & has_room))

    old_val = tvals[sb_c, slot]
    if mode == MODE_ADD:
        store_val = torch.where(found[:, None],
                                to_i32(as_u64(old_val) + as_u64(leader_val)), leader_val)
    elif mode == MODE_KEEP:
        store_val = torch.where(found[:, None], old_val, leader_val)
    else:
        store_val = leader_val

    wb, ws = sb_c[ok_leader], slot[ok_leader]
    tk, tv, st = tkeys.clone(), tvals.clone(), status.clone()
    tk[wb, ws] = sk[ok_leader]
    tv[wb, ws] = store_val[ok_leader]
    st[wb, ws] = (status[wb, ws] & ~STATE_MASK) | READY

    # per-item success = its group leader's success
    succ_g = torch.zeros(m, dtype=_I64, device=dev).index_add_(
        0, group_id, ok_leader.to(_I64))
    success = torch.zeros(m, dtype=torch.bool, device=dev)
    success[order] = (succ_g[group_id] > 0) & svalid
    return tk, tv, st, success


def insert_arrivals_plain(tkeys, tvals, status, seg, valid, mode: int = MODE_SET):
    """Plain insert off an arrival segment: slice the columns, then
    :func:`bulk_insert_plain` (``ops.py:221-224``)."""
    lk = tkeys.shape[2]
    qblock = torch.where(valid, seg[:, 0], 0)
    return bulk_insert_plain(tkeys, tvals, status, qblock, seg[:, 1:1 + lk],
                             seg[:, 1 + lk:], valid, mode)


def insert_arrivals(tkeys, tvals, status, seg, valid, mode: int = MODE_SET):
    """Insert a batch of arrivals; returns new (tkeys, tvals, status, success).

    CUDA: one warp per table block walks that block's arrivals in batch
    order, so the tables equal the sequential oracle's.  The tables are
    copied first (the function is out of place, like the JAX one).
    """
    if not tkeys.is_cuda:
        return insert_arrivals_plain(tkeys, tvals, status, seg, valid, mode)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, seg, valid,
                                      "insert_arrivals", 1 + tkeys.shape[2]
                                      + tvals.shape[2])
    if mode not in (MODE_SET, MODE_ADD, MODE_KEEP):
        raise ValueError(f"insert_arrivals: unknown mode {mode}")
    order, start = bin_queries(seg[:, 0], valid, nb)
    tk, tv, st = tkeys.clone(), tvals.clone(), status.clone()
    ok = torch.zeros(m, dtype=torch.bool, device=tk.device)
    _INSERT(tk, tv, st, seg, seg.stride(0), order,
            start, nb, bsz, lk, lv, mode, ok)
    return tk, tv, st, ok


# --------------------------------------------------------------------------
# find
# --------------------------------------------------------------------------

def find_arrivals_plain(tkeys, tvals, status, seg, valid):
    """Plain find off an arrival segment (``ops.py:202-205``)."""
    lk = tkeys.shape[2]
    qblock = torch.where(valid, seg[:, 0], 0)
    return hash_probe_find_ref(tkeys, tvals, status, qblock, seg[:, 1:1 + lk], valid)


def find_arrivals(tkeys, tvals, status, seg, valid):
    """Find a batch of arrivals; returns (found (M,), values (M, Lv)).

    CUDA: one warp per arrival compares its key with the block's slots.
    """
    if not tkeys.is_cuda:
        return find_arrivals_plain(tkeys, tvals, status, seg, valid)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, seg, valid,
                                      "find_arrivals", 1 + tkeys.shape[2])
    found = torch.empty(m, dtype=torch.bool, device=tkeys.device)
    vals = torch.empty((m, lv), dtype=_I32, device=tkeys.device)
    _FIND(tkeys, tvals, status, seg, seg.stride(0), valid,
          m, nb, bsz, lk, lv, found, vals)
    return found, vals
