"""Concurrency promises (paper section 7), PyTorch port.

A concurrency promise is a callsite annotation listing which data-structure
operations may execute concurrently with the one being issued.  The promise
lets a container statically select a cheaper implementation with weaker
atomicity guarantees (paper Tables 3 and 4).

In the C++ original the promise chooses between AMO-heavy and AMO-free code
paths at template-instantiation time.  Here the promise is a Python-level
constant, so it selects between different *collective schedules and
kernels* when the op is issued.

Promise algebra: promises are bitflags and combine with ``|`` exactly as in
the paper (``ConProm.HashMap.find | ConProm.HashMap.insert``).

Promise -> schedule (DESIGN.md section 1.5): promises tell the runtime
which ops may share a collective round.  The ExchangePlan scheduler
(``core/exchange.py``) fuses the flows of concurrent ops into one
request all-to-all and one reply all-to-all; ``Promise.FINE`` opts a
callsite out of fusion, forcing the sequential one-op-per-round
schedule — the oracle every fused path is tested against.  ``FINE``
composes with any remote promise (``find_insert | FINE`` is the
sequential find-then-insert) but contradicts ``LOCAL`` (a local op has
no collective rounds to schedule): :func:`validate` raises on it.
"""

from __future__ import annotations

import enum


class Promise(enum.IntFlag):
    """Operations that may run concurrently with the annotated callsite."""

    NONE = 0
    FIND = enum.auto()     # hash-map find may be concurrent
    INSERT = enum.auto()   # hash-map insert may be concurrent
    PUSH = enum.auto()     # queue push may be concurrent
    POP = enum.auto()      # queue pop may be concurrent
    LOCAL = enum.auto()    # op targets this process' own shard exclusively
    FINE = enum.auto()     # caller wants fine-grained (per-op) issue, no batching


class _HashMapProms:
    """``ConProm.HashMap.*`` namespace (paper spelling)."""

    find = Promise.FIND
    insert = Promise.INSERT
    local = Promise.LOCAL
    find_insert = Promise.FIND | Promise.INSERT


class _QueueProms:
    """``ConProm.CircularQueue.*`` namespace (paper spelling)."""

    push = Promise.PUSH
    pop = Promise.POP
    local = Promise.LOCAL
    push_pop = Promise.PUSH | Promise.POP


class ConProm:
    """Namespace mirroring the paper's ``ConProm::HashMap::find`` etc."""

    HashMap = _HashMapProms
    CircularQueue = _QueueProms
    FastQueue = _QueueProms

    NONE = Promise.NONE
    FIND = Promise.FIND
    INSERT = Promise.INSERT
    PUSH = Promise.PUSH
    POP = Promise.POP
    LOCAL = Promise.LOCAL
    FINE = Promise.FINE


def validate(promise: Promise) -> Promise:
    """Reject contradictory promise combinations when the op is issued.

    ``FINE`` requests a per-op collective schedule; ``LOCAL`` promises
    the op never leaves this rank, so there is no schedule to pick —
    the combination is nonsense, not merely redundant, and silently
    honoring either half would mask a caller bug.
    """
    if (promise & Promise.FINE) and (promise & Promise.LOCAL):
        raise ValueError(
            f"contradictory promise {promise!r}: FINE selects a "
            "sequential collective schedule but LOCAL promises the op "
            "issues no collectives at all")
    return promise


def fine_grained(promise: Promise) -> bool:
    """True when the callsite opted out of cross-op fusion (Promise.FINE)."""
    return bool(promise & Promise.FINE)


def fully_atomic_hashmap(promise: Promise) -> bool:
    """True when the callsite must assume concurrent finds AND inserts."""
    return bool(promise & Promise.FIND) and bool(promise & Promise.INSERT)


def find_only(promise: Promise) -> bool:
    return bool(promise & Promise.FIND) and not (promise & Promise.INSERT)


def local_only(promise: Promise) -> bool:
    return bool(promise & Promise.LOCAL)


def fully_atomic_queue(promise: Promise) -> bool:
    return bool(promise & Promise.PUSH) and bool(promise & Promise.POP)
