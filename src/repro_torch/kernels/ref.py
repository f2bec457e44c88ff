"""Sequential oracles for the port's kernels (PyTorch port of ``repro.kernels.ref``).

Deliberately simple, obviously correct, and slow: the tests hold the
vectorized plain versions and the CUDA kernels against them.

Hash-table layout (blocked open addressing), all u32 words as int32 views:
  tkeys  (nb, B, Lk)   stored key lanes
  tvals  (nb, B, Lv)   stored value lanes
  status (nb, B)       low 2 bits 0=FREE, 1=RESERVED, 2=READY; high bits
                       are read flags
"""

from __future__ import annotations

import torch

from repro_torch.core.u32 import as_u64, to_i32

FREE, RESERVED, READY = 0, 1, 2
STATE_MASK = 3   # low 2 bits = bucket state; high 30 bits = read flags

MODE_SET, MODE_ADD, MODE_KEEP = 0, 1, 2


def bucket_state(status: torch.Tensor) -> torch.Tensor:
    return status & STATE_MASK


def hash_probe_insert_ref(tkeys, tvals, status, qblock, qkeys, qvals, qvalid,
                          mode: int = MODE_SET):
    """Sequential-semantics blocked insert oracle.

    Items are inserted one at a time in batch order: a matching READY slot
    updates the value (set / add / keep); otherwise the first FREE slot
    in the block is claimed; a full block fails the item.
    Returns new (tkeys, tvals, status, success(M,) bool).
    """
    tk, tv, st = tkeys.clone(), tvals.clone(), status.clone()
    ok = torch.zeros(qblock.shape[0], dtype=torch.bool, device=tk.device)
    for i in range(qblock.shape[0]):
        if not bool(qvalid[i]):
            continue
        b = int(qblock[i])
        state = bucket_state(st[b])
        match = (tk[b] == qkeys[i][None, :]).all(dim=1) & (state == READY)
        free = state == FREE
        if bool(match.any()):
            slot = int(torch.argmax(match.to(torch.uint8)))
            if mode == MODE_SET:
                tv[b, slot] = qvals[i]
            elif mode == MODE_ADD:
                tv[b, slot] = to_i32(as_u64(tv[b, slot]) + as_u64(qvals[i]))
        elif bool(free.any()):
            slot = int(torch.argmax(free.to(torch.uint8)))
            tv[b, slot] = qvals[i]
        else:
            continue
        tk[b, slot] = qkeys[i]
        st[b, slot] = (st[b, slot] & ~STATE_MASK) | READY
        ok[i] = True
    return tk, tv, st, ok


def hash_probe_find_ref(tkeys, tvals, status, qblock, qkeys, qvalid):
    """Blocked find oracle: (found(M,), values(M, Lv))."""
    qblock = qblock.long()
    blk_keys = tkeys[qblock]                       # (M, B, Lk)
    blk_stat = status[qblock]                      # (M, B)
    match = (blk_keys == qkeys[:, None, :]).all(dim=2) & (bucket_state(blk_stat) == READY)
    found = match.any(dim=1) & qvalid
    slot = torch.argmax(match.to(torch.uint8), dim=1)
    vals = tvals[qblock, slot]
    return found, torch.where(found[:, None], vals, torch.zeros_like(vals))


def bin_offsets_ref(bins: torch.Tensor, nbins: int, valid=None):
    """Sequential oracle for exchange send-buffer construction.

    Returns ``(counts (nbins,), offsets (N,))`` where ``offsets[i]`` is
    the number of valid items ``j < i`` with ``bins[j] == bins[i]``.
    Offsets of invalid items are unspecified (callers mask them).
    """
    n = bins.shape[0]
    valid = [True] * n if valid is None else valid.tolist()
    counts, offs = [0] * nbins, []
    for b, v in zip(bins.tolist(), valid):
        b = min(max(b, 0), nbins - 1)
        offs.append(counts[b])
        counts[b] += int(v)
    return (torch.tensor(counts, dtype=torch.int32, device=bins.device),
            torch.tensor(offs, dtype=torch.int32, device=bins.device))
