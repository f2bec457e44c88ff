"""Owner-side hash probe kernels: the arrival front ends
``insert_arrivals``/``find_arrivals`` and the column front ends
``insert``/``find``.

Each wrapper launches its hand-written CUDA kernel
(``csrc/hash_probe.cu``) on CUDA tensors and takes its plain PyTorch
version only for CPU tensors.  The plain versions are the JAX package's
vectorized jnp paths (``repro/kernels/ops.py:72-223``), bit for bit.

``seg`` is the exchange's owner view of an arrival segment: rows of
[local block | key lanes | value lanes]; its rows may be strided (a
column slice of the wire segment), its words must be contiguous.  The
column front ends take ``qblock (M,)``, ``qkeys (M, Lk)``, ``qvals
(M, Lv)`` and ``qvalid (M,)`` as separate arrays (the local-promise
path of the hash map); key and value rows may be strided too.

No kernel has a per-block query capacity: the JAX package's Pallas
kernels fail (insert) or re-probe (find) items past ``q_cap``, the port
serves every item, as the jnp path does.  Each CUDA kernel stages one
block per warp in shared memory (status, keys, for insert values, and
lists of its slots): a block too large for 227 KB is refused with a
CUDA invalid-argument error.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.u32 import as_u64, to_i32
from repro_torch.kernels import binning
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
    [_P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _LL, _INT, _INT, _INT, _INT, _P]))
_FIND = register("find_arrivals", Kernel(
    "hash_probe", "find_arrivals_launch",
    [_P, _P, _P, _P, _LL, _P, _P, _P, _LL, _LL, _INT, _INT, _INT, _P, _P]))
_INSERT_COLS = register("insert", Kernel(
    "hash_probe", "insert_launch",
    [_P, _P, _P, _P, _P, _P, _P, _LL, _P, _LL, _P, _P, _LL, _INT, _INT, _INT, _INT, _P]))
_FIND_COLS = register("find", Kernel(
    "hash_probe", "find_launch",
    [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _LL, _LL, _INT, _INT, _INT, _P, _P]))

#: queries per block from which the finds go block-major: below it the
#: CSR and a warp per block cost more than sharing a staged block saves
#: (``chip_smoke.py`` times both routes on either side of it)
DENSE_QUERIES = 2


def bin_queries(qblock: torch.Tensor, valid: torch.Tensor, nb: int):
    """CSR of the items by local block: ``(order (M,), start (nb+1,))``.

    ``order[start[b]:start[b+1]]`` are block b's valid items in batch
    order (a stable grouping), as ``repro/kernels/hash_probe.py:49-67``
    bins them outside its kernel; the items after ``start[nb]`` (invalid,
    or a block outside ``[0, nb)``) are not probed.  :func:`binning.bin_csr`
    (on the card its stable counting sort by digits of the block).
    """
    return binning.bin_csr(qblock, nb, valid)


def _check_rows(t, name: str, m: int, lanes: int, dev) -> None:
    """Raise unless ``t`` is (m, >= lanes) int32 rows of contiguous words."""
    if (t.dtype != _I32 or t.device != dev or t.ndim != 2 or t.shape[0] != m
            or t.shape[1] < lanes or (m and t.shape[1] > 1 and t.stride(1) != 1)):
        raise ValueError(f"{name}: want ({m}, >= {lanes}) int32 rows of contiguous "
                         f"words on {dev}, got {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride() if t.ndim else ()} on {t.device}")


def _check_table(tkeys, tvals, status, rows, valid, what: str, row_lanes: int):
    nb, bsz, lk = tkeys.shape
    lv = tvals.shape[2]
    dev = tkeys.device
    require(tkeys, f"{what} tkeys", _I32, (nb, bsz, lk), dev)
    require(tvals, f"{what} tvals", _I32, (nb, bsz, lv), dev)
    require(status, f"{what} status", _I32, (nb, bsz), dev)
    m = rows.shape[0]
    require(valid, f"{what} valid", torch.bool, (m,), dev)
    _check_rows(rows, f"{what} rows", m, row_lanes, dev)
    if lk > MAX_LANES or lv > MAX_LANES:
        raise ValueError(f"{what}: {lk} key / {lv} value lanes; the kernel "
                         f"serves at most {MAX_LANES}")
    return nb, bsz, lk, lv, m


def _check_mode(mode: int, what: str) -> None:
    if mode not in (MODE_SET, MODE_ADD, MODE_KEEP):
        raise ValueError(f"{what}: unknown mode {mode}")


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


def insert_plain(tkeys, tvals, status, qblock, qkeys, qvals, qvalid,
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
    :func:`insert_plain` (``ops.py:221-224``)."""
    lk = tkeys.shape[2]
    qblock = torch.where(valid, seg[:, 0], 0)
    return insert_plain(tkeys, tvals, status, qblock, seg[:, 1:1 + lk],
                        seg[:, 1 + lk:], valid, mode)


def insert_arrivals(tkeys, tvals, status, seg, valid, mode: int = MODE_SET):
    """Insert a batch of arrivals; returns new (tkeys, tvals, status, success).

    CUDA: the CSR groups the arrivals by block in batch order, then one
    warp per table block stages the block in shared memory, resolves its
    arrivals 32 at a time and writes the block into fresh output tables
    (every block: the function is out of place, like the JAX one, and the
    copy rides on the kernel's own read and write of the table).
    """
    if not tkeys.is_cuda:
        return insert_arrivals_plain(tkeys, tvals, status, seg, valid, mode)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, seg, valid,
                                      "insert_arrivals", 1 + tkeys.shape[2]
                                      + tvals.shape[2])
    _check_mode(mode, "insert_arrivals")
    order, start = bin_queries(seg[:, 0], valid, nb)
    tk, tv, st = (torch.empty_like(t) for t in (tkeys, tvals, status))
    ok = torch.zeros(m, dtype=torch.bool, device=tk.device)
    _INSERT(tkeys, tvals, status, tk, tv, st, seg, seg.stride(0), order, start, nb, bsz,
            lk, lv, mode, ok)
    return tk, tv, st, ok


def insert(tkeys, tvals, status, qblock, qkeys, qvals, qvalid, mode: int = MODE_SET):
    """Insert a batch of column arrays; returns new (tkeys, tvals, status,
    success).

    CUDA: the same kernel as :func:`insert_arrivals`, reading each item's
    key and value words from ``qkeys``/``qvals`` in place.
    """
    if not tkeys.is_cuda:
        return insert_plain(tkeys, tvals, status, qblock, qkeys, qvals, qvalid, mode)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, qkeys, qvalid, "insert",
                                      tkeys.shape[2])
    require(qblock, "insert qblock", _I32, (m,), tkeys.device)
    _check_rows(qvals, "insert qvals", m, lv, tkeys.device)
    _check_mode(mode, "insert")
    order, start = bin_queries(qblock, qvalid, nb)
    tk, tv, st = (torch.empty_like(t) for t in (tkeys, tvals, status))
    ok = torch.zeros(m, dtype=torch.bool, device=tk.device)
    _INSERT_COLS(tkeys, tvals, status, tk, tv, st, qkeys, qkeys.stride(0), qvals,
                 qvals.stride(0), order, start, nb, bsz, lk, lv, mode, ok)
    return tk, tv, st, ok


# --------------------------------------------------------------------------
# find
# --------------------------------------------------------------------------

def find_plain(tkeys, tvals, status, qblock, qkeys, qvalid):
    """Plain column find: the blocked-find oracle (``ref.py``), which is
    the jnp path (``ops.py:181-187``)."""
    return hash_probe_find_ref(tkeys, tvals, status, qblock, qkeys, qvalid)


def _find_csr(qblock, valid, m: int, nb: int):
    """The CSR of a dense batch (at least :data:`DENSE_QUERIES` queries a
    block): the block-major route; ``(0, 0)``, null pointers, selects the
    sparse route (one warp per query)."""
    return bin_queries(qblock, valid, nb) if m >= DENSE_QUERIES * nb else (0, 0)


def find(tkeys, tvals, status, qblock, qkeys, qvalid):
    """Find a batch of column arrays; returns (found (M,), values (M, Lv)).

    CUDA: as :func:`find_arrivals`; ``qblock`` is read only for valid
    queries; invalid queries and blocks outside ``[0, nb)`` give found 0
    and zero values.
    """
    if not tkeys.is_cuda:
        return find_plain(tkeys, tvals, status, qblock, qkeys, qvalid)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, qkeys, qvalid, "find",
                                      tkeys.shape[2])
    require(qblock, "find qblock", _I32, (m,), tkeys.device)
    order, start = _find_csr(qblock, qvalid, m, nb)
    found = torch.empty(m, dtype=torch.bool, device=tkeys.device)
    vals = torch.empty((m, lv), dtype=_I32, device=tkeys.device)
    _FIND_COLS(tkeys, tvals, status, qblock, qkeys, qkeys.stride(0), qvalid, order, start,
               m, nb, bsz, lk, lv, found, vals)
    return found, vals


def find_arrivals_plain(tkeys, tvals, status, seg, valid):
    """Plain find off an arrival segment (``ops.py:202-205``)."""
    lk = tkeys.shape[2]
    qblock = torch.where(valid, seg[:, 0], 0)
    return hash_probe_find_ref(tkeys, tvals, status, qblock, seg[:, 1:1 + lk], valid)


def find_arrivals(tkeys, tvals, status, seg, valid):
    """Find a batch of arrivals; returns (found (M,), values (M, Lv)).

    CUDA: block-major for a dense batch (:data:`DENSE_QUERIES` queries a
    block or more): the CSR groups the queries by block, then one warp
    per touched block stages its status and keys in shared memory once
    and answers its queries, 32 at a time, into each query's own row.  A
    sparser batch takes one warp per query, no CSR.  Invalid queries and
    blocks outside ``[0, nb)`` find nothing.
    """
    if not tkeys.is_cuda:
        return find_arrivals_plain(tkeys, tvals, status, seg, valid)
    nb, bsz, lk, lv, m = _check_table(tkeys, tvals, status, seg, valid,
                                      "find_arrivals", 1 + tkeys.shape[2])
    order, start = _find_csr(seg[:, 0], valid, m, nb)
    found = torch.empty(m, dtype=torch.bool, device=tkeys.device)
    vals = torch.empty((m, lv), dtype=_I32, device=tkeys.device)
    _FIND(tkeys, tvals, status, seg, seg.stride(0), valid, order, start, m, nb, bsz, lk, lv,
          found, vals)
    return found, vals
