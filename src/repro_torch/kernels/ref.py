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


# --------------------------------------------------------------------------
# blocked Bloom filter
# --------------------------------------------------------------------------

def bloom_words_ref(hashes: torch.Tensor, k: int) -> torch.Tensor:
    """Expand (M, k) u32 hashes (each in [0, 64)) into 64-bit block words
    represented as (M, 2) [lo, hi] int32 words."""
    bits = as_u64(hashes)
    lo = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    hi = torch.zeros_like(lo)
    for i in range(k):
        bit = torch.ones_like(lo) << (bits[:, i] % 32)
        lo = lo | torch.where(bits[:, i] < 32, bit, 0)
        hi = hi | torch.where(bits[:, i] >= 32, bit, 0)
    return to_i32(torch.stack([lo, hi], dim=1))


def bloom_insert_ref(filter_words, qblock, qwords, qvalid):
    """Sequential-semantics blocked Bloom insert oracle.

    filter_words: (nblocks, 2) words.  Returns (filter_words,
    already_present(M,)): item i is "already present" iff all of its bits
    were set before *its own* insertion (earlier batch items count:
    first-inserter-wins atomicity, paper section 5.4.2).
    """
    fw = filter_words.clone()
    present = torch.zeros(qblock.shape[0], dtype=torch.bool, device=fw.device)
    for i in range(qblock.shape[0]):
        if not bool(qvalid[i]):
            continue
        b = int(qblock[i])
        cur, w = fw[b].clone(), qwords[i]
        present[i] = bool(((cur & w) == w).all())
        fw[b] = cur | w
    return fw, present


def bloom_find_ref(filter_words, qblock, qwords, qvalid):
    """All of each query's bits set in its block word; (M,) bool."""
    cur = filter_words[qblock.long()]                 # (M, 2)
    return ((cur & qwords) == qwords).all(dim=1) & qvalid


def bin_histogram_ref(bins: torch.Tensor, nbins: int, valid=None) -> torch.Tensor:
    """Per-bin counts of the valid items, one item at a time (bins outside
    ``[0, nbins)`` are not counted)."""
    n = bins.shape[0]
    valid = [True] * n if valid is None else valid.tolist()
    counts = [0] * nbins
    for b, v in zip(bins.tolist(), valid):
        if v and 0 <= b < nbins:
            counts[b] += 1
    return torch.tensor(counts, dtype=torch.int32, device=bins.device)


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


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """Plain softmax attention oracle (``repro.kernels.ref.flash_attention_ref``).

    q: (B, Hq, Tq, D), k/v: (B, Hkv, Tk, D); GQA by head repetition.
    Queries are suffix-aligned to the keys (query i sits at position
    ``i + Tk - Tq``); ``window`` > 0 limits attention to the last
    ``window`` keys (sliding).  Logits and softmax are float32 (the JAX
    oracle takes its logits in ``q.dtype``; the TPU kernel and
    ``blockwise_attention`` upcast, and the port follows those two); the
    probabilities are cast to ``q.dtype`` before the value product, as
    in the JAX oracle.  A row with no key to see is NaN.
    """
    _, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
