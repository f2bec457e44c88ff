"""The port's queue, HashMapBuffer, Bloom filter, DArray and heap against
the JAX package at P=1.

Each scenario is written once against either package (``X`` carries the
package's container modules and constructors) and runs on the same
numpy inputs over a ``SerialBackend``: the JAX side under a fresh
``jax.jit`` inside ``costs.recording()`` (JAX records costs at trace
time) with ``impl="jnp"``, the port with its plain versions on the CPU.
Queue scenarios start both packages from the same populated ring,
carried across with ``repro_torch.interop``.  Every output is integer
(the fill fraction a float32 of integers), so they must agree bit for
bit: states, successes, drops, carry masks, values, and every field of
the cost log per op name.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ShapeDtypeStruct as SDS

from repro.containers import bloom as jbl
from repro.containers import darray as jda
from repro.containers import hashmap as jhm
from repro.containers import hashmap_buffer as jhb
from repro.containers import heap as jheap
from repro.containers import queue as jq
from repro.core import costs as jcosts
from repro.core import exchange as jex
from repro.core.backend import SerialBackend as JSerial
from repro.core.pointers import GlobalPointer as JPtr
from repro.core.promises import ConProm as JConProm
from repro_torch import interop
from repro_torch.containers import bloom as tbl
from repro_torch.containers import darray as tda
from repro_torch.containers import hashmap as thm
from repro_torch.containers import hashmap_buffer as thb
from repro_torch.containers import heap as theap
from repro_torch.containers import queue as tq
from repro_torch.core import costs as tcosts
from repro_torch.core import exchange as tex
from repro_torch.core.backend import SerialBackend as TSerial
from repro_torch.core.object_container import Spec
from repro_torch.core.pointers import GlobalPointer as TPtr
from repro_torch.core.promises import ConProm as TConProm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 96          # batch per op
RING = 64       # ring capacity per rank


def _pkg(port: bool):
    """One package's modules and constructors, the port's on the CPU."""
    dt = torch.uint32 if port else jnp.uint32
    spec = Spec if port else SDS
    kw = {"device": "cpu"} if port else {}
    impl = "torch" if port else "jnp"
    X = types.SimpleNamespace(
        q=tq if port else jq, hb=thb if port else jhb, hm=thm if port else jhm,
        bl=tbl if port else jbl, da=tda if port else jda,
        heap=theap if port else jheap, P=TConProm if port else JConProm,
        Ptr=TPtr if port else JPtr, bk=TSerial() if port else JSerial(),
        ex=tex if port else jex, cat=torch.cat if port else jnp.concatenate,
        u32=spec((), dt), v2=spec((2,), dt),
        kv={"hi": spec((), dt), "lo": spec((), dt)})
    X.queue = lambda cap, circular=False: X.q.queue_create(X.bk, cap, X.v2,
                                                           circular=circular, **kw)
    X.hashmap = lambda cap, block: X.hm.hashmap_create(X.bk, cap, X.u32, X.u32,
                                                       block_size=block, impl=impl, **kw)
    X.bloom = lambda nbits, k: X.bl.bloom_create(X.bk, nbits, X.kv, k=k, impl=impl, **kw)
    X.darray = lambda n: X.da.darray_create(X.bk, n, X.v2, **kw)
    X.heap_new = lambda rows, lanes: X.heap.heap_create(X.bk, rows, lanes, **kw)
    return X


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _data(seed):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(1 << 20)[:N].astype(np.uint32) * np.uint32(2654435761)
    keys[-10:] = keys[:10]                          # in-batch duplicates
    items_hi = _u32(rng, N, 64)
    items_lo = _u32(rng, N)
    items_hi[-12:], items_lo[-12:] = items_hi[:12], items_lo[:12]
    return {
        "v2": _u32(rng, (N, 2)), "zeros": np.zeros(N, np.int32),
        "mask": rng.random(N) < 0.9, "keys": keys, "vals": _u32(rng, N),
        "hi": items_hi, "lo": items_lo, "qhi": np.concatenate([items_hi[:N // 2],
                                                               _u32(rng, N // 2, 64)]),
        "qlo": np.concatenate([items_lo[:N // 2], _u32(rng, N // 2)]),
        "idx": rng.permutation(200)[:N].astype(np.int32),
        "idx_dup": rng.integers(0, 200, N).astype(np.int32),
        "rows": _u32(rng, (40, 3)), "len10": np.full(3, 10, np.int32),
        "len5": np.full(2, 5, np.int32),
    }


# --------------------------------------------------------------------------
# scenarios: X is the package, d its inputs, q0 the shared populated ring
# --------------------------------------------------------------------------

def _ring(X, d, circular=False):
    spec, _ = X.queue(RING, circular)
    return spec, X.q.restore_state(spec, d["q0"])


def sc_queue_push_drop(X, d):
    spec, st = _ring(X, d)
    st, pushed, dropped = X.q.push(X.bk, spec, st, d["v2"], d["zeros"], capacity=40,
                                   valid=d["mask"])
    return {"state": st, "pushed": pushed, "dropped": dropped, "size": X.q.size(st)}


def sc_queue_push_carry(X, d):
    spec, st = _ring(X, d)
    st, pushed, dropped, carry = X.q.push(X.bk, spec, st, d["v2"], d["zeros"],
                                          capacity=24, max_rounds=2, overflow="carry")
    st2, p2, d2, c2 = X.q.push(X.bk, spec, st, d["v2"], d["zeros"], capacity=N,
                               promise=X.P.CircularQueue.local, overflow="carry")
    return {"state": st, "pushed": pushed, "dropped": dropped, "carry": carry,
            "state2": st2, "pushed2": p2, "dropped2": d2, "carry2": c2}


def sc_queue_pop(X, d):
    spec, st = _ring(X, d)
    st, vals, got = X.q.pop(X.bk, spec, st, 30, 0)
    st, vals2, got2 = X.q.pop(X.bk, spec, st, 30, 0)
    return {"state": st, "vals": vals, "got": got, "vals2": vals2, "got2": got2}


def sc_queue_push_pop(X, d):
    spec, st = _ring(X, d)
    out = X.q.push_pop(X.bk, spec, st, d["v2"][:50], d["zeros"][:50], 50, 40, 0)
    out_c = X.q.push_pop(X.bk, spec, st, d["v2"], d["zeros"], 32, 20, 0,
                         overflow="carry", max_rounds=2)
    return {"fused": out, "carry": out_c}


def sc_queue_push_pop_fine_circular(X, d):
    spec, st = _ring(X, d, circular=True)
    out = X.q.push_pop(X.bk, spec, st, d["v2"][:50], d["zeros"][:50], 50, 40, 0,
                       promise=X.P.CircularQueue.push_pop | X.P.FINE)
    out_c = X.q.push_pop(X.bk, spec, st, d["v2"], d["zeros"], 32, 20, 0,
                         promise=X.P.CircularQueue.push_pop | X.P.FINE,
                         overflow="carry")
    return {"fine": out, "carry": out_c}


def sc_queue_local_ops(X, d):
    spec, st = _ring(X, d)
    st, vals, got = X.q.local_nonatomic_pop(spec, st, 12)
    rows, live = X.q.local_drain(spec, st)
    st2, v2, g2 = X.q.pop(X.bk, spec, st, 5, 0, promise=X.P.CircularQueue.local)
    spec_r, st_r = X.q.resize(X.bk, spec, st, 24)
    rows_r, live_r = X.q.local_drain(spec_r, st_r)
    st_m = X.q.migrate(X.bk, spec, st)
    back = X.q.restore_state(spec, X.q.export_state(spec, st))
    return {"state": st, "vals": vals, "got": got, "rows": rows, "live": live,
            "state2": st2, "v2": v2, "g2": g2, "resized": st_r, "rows_r": rows_r,
            "live_r": live_r, "migrated": st_m, "restored": back}


def _buffer(X, cap=512, block=8, qcap=128, bcap=64):
    mspec, mst = X.hashmap(cap, block)
    return X.hb.create(X.bk, mspec, mst, queue_capacity=qcap, buffer_cap=bcap)


def sc_buffer_insert_spill(X, d):
    spec, st = _buffer(X)
    st, over = X.hb.insert(spec, st, d["keys"], d["vals"], valid=d["mask"])
    st, dropped = X.hb.spill(X.bk, spec, st, capacity=40)
    return {"state": st, "over": over, "dropped": dropped}


def sc_buffer_flush(X, d):
    spec, st = _buffer(X, bcap=128)
    st, over = X.hb.insert(spec, st, d["keys"], d["vals"])
    st, dropped = X.hb.flush(X.bk, spec, st, capacity=N)
    st, over2 = X.hb.insert(spec, st, d["keys"][:40], d["vals"][:40])
    st, dropped2 = X.hb.flush(X.bk, spec, st, capacity=N, mode=1)
    return {"state": st, "over": over, "dropped": dropped, "over2": over2,
            "dropped2": dropped2}


def sc_buffer_flush_drop(X, d):
    # a small table (blocks fill) and a short ring and wire (drops)
    spec, st = _buffer(X, cap=64, block=4, qcap=48, bcap=128)
    st, _ = X.hb.insert(spec, st, d["keys"], d["vals"])
    st, dropped = X.hb.flush(X.bk, spec, st, capacity=80)
    return {"state": st, "dropped": dropped}


def sc_buffer_flush_carry(X, d):
    spec, st = _buffer(X, qcap=48, bcap=128)
    st, _ = X.hb.insert(spec, st, d["keys"], d["vals"])
    st, dropped = X.hb.flush(X.bk, spec, st, capacity=32, overflow="carry")
    st2, dropped2 = X.hb.flush(X.bk, spec, st, capacity=32, overflow="carry",
                               max_rounds=2)
    # carry without the ring reply: the spill rides a caller's plan
    st3, _ = X.hb.insert(spec, st2, d["keys"][:30], d["vals"][:30])
    plan = X.ex.ExchangePlan(name="queue.push")
    h = X.hb.spill_flow(plan, spec, st3, 16)
    st4, dropped4 = X.hb.spill_apply(X.bk, plan.commit(X.bk), h, spec, st3,
                                     overflow="carry")
    return {"state": st, "dropped": dropped, "state2": st2, "dropped2": dropped2,
            "state4": st4, "dropped4": dropped4}


def sc_bloom_insert_find(X, d):
    spec, st = X.bloom(1 << 12, 4)
    items = {"hi": d["hi"], "lo": d["lo"]}
    st, already = X.bl.insert(X.bk, spec, st, items, capacity=N, valid=d["mask"])
    present = X.bl.find(X.bk, spec, st, {"hi": d["qhi"], "lo": d["qlo"]}, capacity=N)
    st2, already2 = X.bl.insert(X.bk, spec, st, items, capacity=40, max_rounds=2)
    return {"state": st, "already": already, "present": present, "state2": st2,
            "already2": already2, "fill": X.bl.fill_fraction(X.bk, st2)}


def sc_bloom_insert_find_fused(X, d):
    spec, st = X.bloom(1 << 10, 3)
    ins = {"hi": d["hi"], "lo": d["lo"]}
    qry = {"hi": d["qhi"], "lo": d["qlo"]}
    fused = X.bl.insert_find(X.bk, spec, st, ins, qry, N, N, ins_valid=d["mask"])
    fine = X.bl.insert_find(X.bk, spec, st, ins, qry, N, N, ins_valid=d["mask"],
                            promise=X.P.FINE)
    return {"fused": fused, "fine": fine}


def sc_darray(X, d):
    spec, st = X.darray(200)
    st = X.da.rput(X.bk, spec, st, d["idx"], d["v2"], capacity=N)
    st = X.da.rput(X.bk, spec, st, d["idx_dup"], d["v2"], capacity=N, mode="add")
    vals, found = X.da.rget(X.bk, spec, st, d["idx_dup"], capacity=N)
    st = X.da.local_write(spec, st, d["idx"][:5], d["v2"][:5])
    return {"state": st, "vals": vals, "found": found,
            "read": X.da.local_read(spec, st, d["idx"][:7]),
            "global": X.da.to_global(X.bk, spec, st)}


def sc_heap(X, d):
    spec, st = X.heap_new(48, 3)
    rows = d["rows"]
    st, p1, ok1 = X.heap.store_local(X.bk, spec, st, rows[:30], d["len10"])
    st, p2, ok2 = X.heap.store_local(X.bk, spec, st, rows[30:], d["len5"])
    st, p3, ok3 = X.heap.store_local(X.bk, spec, st, rows[:20], d["len10"][:2])
    ptrs = X.Ptr(*(X.cat([a, b]) for a, b in zip(p1, p3)))
    got, found, dropped = X.heap.rget_rows(X.bk, spec, st, ptrs, 10, capacity=8)
    got2, found2, dropped2 = X.heap.rget_rows(X.bk, spec, st, p2, 6, capacity=2,
                                              max_rounds=2)
    return {"state": st, "p1": p1, "ok1": ok1, "p2": p2, "ok2": ok2, "p3": p3,
            "ok3": ok3, "got": got, "found": found, "dropped": dropped, "got2": got2,
            "found2": found2, "dropped2": dropped2}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_queue_push_drop, sc_queue_push_carry, sc_queue_pop, sc_queue_push_pop,
    sc_queue_push_pop_fine_circular, sc_queue_local_ops,
    sc_buffer_insert_spill, sc_buffer_flush, sc_buffer_flush_drop, sc_buffer_flush_carry,
    sc_bloom_insert_find, sc_bloom_insert_find_fused, sc_darray, sc_heap)}


@pytest.fixture(scope="module")
def ring0():
    """A ring populated by the JAX package (20 pushed, 6 popped), as numpy."""
    X = _pkg(port=False)
    spec, st = X.queue(RING)
    rng = np.random.default_rng(5)

    @jax.jit
    def fill(st, rows):
        st, _, _ = jq.push(X.bk, spec, st, rows, jnp.zeros(20, jnp.int32), capacity=20)
        return jq.local_nonatomic_pop(spec, st, 6)[0]
    st = fill(st, jnp.asarray(_u32(rng, (20, 2))))
    return {k: np.asarray(v) for k, v in jq.export_state(spec, st).items()}


def _leaves(x, name=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{name}.{k}")
    elif isinstance(x, tuple):
        fields = getattr(x, "_fields", range(len(x)))
        for f, v in zip(fields, x):
            yield from _leaves(v, f"{name}.{f}")
    elif isinstance(x, torch.Tensor):
        yield name, x.numpy()
    else:
        yield name, np.asarray(x)


def _costs(log):
    names = sorted({name for name, _ in log.entries})
    return {name: log.by_op(name).__dict__ for name in names}


def _run_both(scenario, d, q0):
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    jd["q0"] = {k: jnp.asarray(v) for k, v in q0.items()}
    XJ = _pkg(port=False)
    with jcosts.recording() as jlog:
        jout = jax.jit(lambda dd: scenario(XJ, dd))(jd)

    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    td["q0"] = interop.queue_state_from_numpy(q0, device="cpu")._asdict()
    with tcosts.recording() as tlog:
        tout = scenario(_pkg(port=True), td)
    return jout, jlog, tout, tlog


def _assert_same(jout, tout, what):
    jl, tl = dict(_leaves(jout)), dict(_leaves(tout))
    assert sorted(jl) == sorted(tl), what
    for k in jl:
        j, t = jl[k], tl[k]
        if t.dtype != j.dtype and t.dtype.itemsize == j.dtype.itemsize:
            t = t.view(j.dtype)
        assert j.shape == t.shape and np.array_equal(j, t), f"{what}: {k}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_container_matches_jax(ring0, name):
    jout, jlog, tout, tlog = _run_both(SCENARIOS[name], _data(1), ring0)
    _assert_same(jout, tout, name)
    assert _costs(jlog) == _costs(tlog), f"{name}: cost log"




def test_scenarios_exercise_the_edges(ring0):
    """The scenarios are not vacuous: drops, carries, in-batch duplicates
    and false absences all occur."""
    _, _, t, _ = _run_both(sc_queue_push_drop, _data(1), ring0)
    assert int(t["dropped"]) > 0
    _, _, t, _ = _run_both(sc_queue_push_carry, _data(1), ring0)
    assert bool(t["carry"].any()) and int(t["dropped"]) == 0
    _, _, t, _ = _run_both(sc_bloom_insert_find, _data(1), ring0)
    assert bool(t["already"].any()) and not bool(t["already"].all())
    assert int(t["already2"].sum()) > int(t["already"].sum())
    _, _, t, _ = _run_both(sc_buffer_flush_drop, _data(1), ring0)
    assert int(t["dropped"]) > 0
    _, _, t, _ = _run_both(sc_buffer_flush_carry, _data(1), ring0)
    assert int(t["state"].buf_n[0]) > 0 and int(t["dropped"]) == 0
    _, _, t, _ = _run_both(sc_heap, _data(1), ring0)
    assert not bool(t["ok3"].any()) and bool(t["ok1"].all())
    assert not bool(t["found"][3:].any()) and bool(t["found"][:3].all())


def test_async_raises_naming_the_roadmap():
    """The split-phase container ops are ported: each ``async_=True`` op
    returns a one-shot future that finishes to the synchronous result."""
    X = _pkg(port=True)
    spec, st = X.queue(8)
    v = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    dst = torch.zeros(2, dtype=torch.int32)
    pend = tq.push_pop(X.bk, spec, st, v, dst, 2, 1, 0, async_=True)
    got = pend.finish()
    want = tq.push_pop(X.bk, spec, st, v, dst, 2, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    with pytest.raises(ValueError, match="already finished"):
        pend.finish()
    hspec, hst = _buffer(X)
    hst, _ = thb.insert(hspec, hst, v[:, 0], v[:, 1])
    a, b = thb.flush(X.bk, hspec, hst, 4, async_=True).finish(), thb.flush(X.bk, hspec, hst, 4)
    assert torch.equal(a[0].map.tkeys, b[0].map.tkeys) and int(a[1]) == int(b[1])
    bspec, bst = X.bloom(64, 2)
    items = {"hi": v[:, 0], "lo": v[:, 1]}
    a = tbl.insert_find(X.bk, bspec, bst, items, items, 2, 2, async_=True).finish()
    b = tbl.insert_find(X.bk, bspec, bst, items, items, 2, 2)
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


class _ThousandRanks(TSerial):
    """A serial backend whose psum adds 1024 copies of the rank's value:
    1024 ranks that hold the same filter shard."""

    def psum(self, x):
        return x * 1024


def test_fill_fraction_counts_past_int32():
    """``fill_fraction`` counts its bits in int64: 1024 ranks of 2**21 bits
    hold 2**31 bits, one past int32, and half of them are set."""
    words = torch.full((1 << 15, 2), 0x0F0F0F0F, dtype=torch.int32)
    fill = tbl.fill_fraction(_ThousandRanks(), tbl.BloomState(words))
    assert fill.dtype == torch.float32 and float(fill) == 0.5
