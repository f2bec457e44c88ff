"""The port's exchange extensions against the JAX package at P=1.

Wire checksums (``integrity=True``) under corrupt, drop and kill fault
specs, degraded commits (``dead_ranks=``), the ``Promise.FINE`` plan
oracle, split-phase ``commit_async``, the hierarchical transport, and
every container's ``async_=True`` op; and the plain versions of
``mix_rows``, ``bin_histogram`` and ``ragged_slots``/``stage_slots``
against the JAX package's ``jnp`` paths and its Pallas kernels in
interpret mode.

Each scenario is written once against either package (``X`` carries its
modules) and runs on the same numpy inputs over a ``SerialBackend``: the
JAX side under a fresh ``jax.jit`` inside ``costs.recording()`` (JAX
records costs, and a fault transport numbers launches, at trace time),
the port with its plain versions on the CPU.  Every output is integer,
so they must agree bit for bit: views, drops, ``lost``, replies, tables,
and every field of the cost log per op name.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ShapeDtypeStruct as SDS

import repro.core as jcore
from repro.containers import bloom as jbl
from repro.containers import hashmap as jhm
from repro.containers import hashmap_buffer as jhb
from repro.containers import queue as jq
from repro.core import costs as jcosts
from repro.core import exchange as jex
from repro.core.backend import SerialBackend as JSerial
from repro.core.promises import ConProm as JConProm
from repro.core.promises import Promise as JPromise
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch.containers import bloom as tbl
from repro_torch.containers import hashmap as thm
from repro_torch.containers import hashmap_buffer as thb
from repro_torch.containers import queue as tq
from repro_torch.core import costs as tcosts
from repro_torch.core import exchange as tex
from repro_torch.core.backend import SerialBackend as TSerial
from repro_torch.core.object_container import Spec
from repro_torch.core.promises import ConProm as TConProm
from repro_torch.core.promises import Promise as TPromise
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 60          # rows per flow


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy -> port tensor (u32 words as int32 views)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _flat(x, path=""):
    """Nested outputs (dicts, tuples, NamedTuples, arrays) -> {path: numpy}."""
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_flat(x[k], f"{path}/{k}"))
        return out
    if isinstance(x, (tuple, list)):
        out = {}
        for i, v in enumerate(x):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return {path: a.view(np.uint32) if a.dtype == np.int32 else a}
    a = np.asarray(x)
    return {path: a.view(np.uint32) if a.dtype == np.int32 else a}


def _costs(log):
    return {name: log.by_op(name).__dict__ for name in sorted({n for n, _ in log.entries})}


def _pkg(port: bool, impl: str = "jnp"):
    """One package's modules; the port runs its plain versions on the CPU."""
    core = tcore if port else jcore
    dt = torch.uint32 if port else jnp.uint32
    spec = Spec if port else SDS
    kw = {"device": "cpu"} if port else {}
    X = types.SimpleNamespace(
        core=core, ex=tex if port else jex, bk=TSerial() if port else JSerial(),
        impl="torch" if port else impl, P=TConProm if port else JConProm,
        Promise=TPromise if port else JPromise, hm=thm if port else jhm,
        q=tq if port else jq, bl=tbl if port else jbl, hb=thb if port else jhb,
        u32=spec((), dt), v2=spec((2,), dt))
    X.hashmap = lambda cap, block: X.hm.hashmap_create(X.bk, cap, X.u32, X.u32,
                                                       block_size=block, impl=X.impl, **kw)
    X.queue = lambda cap: X.q.queue_create(X.bk, cap, X.v2, **kw)
    X.bloom = lambda nbits: X.bl.bloom_create(X.bk, nbits, X.v2, k=3, impl=X.impl, **kw)
    return X


def _run_both(scenario, d, impl="jnp"):
    """Run ``scenario`` through the JAX package (jit, trace-time costs) and
    the port; assert equal outputs and cost logs; return the port's."""
    J = _pkg(False, impl)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    with jcosts.recording() as jlog:
        jout = jax.jit(lambda dd: scenario(J, dd))(jd)
    T = _pkg(True)
    td = {k: _t(v) for k, v in d.items()}
    with tcosts.recording() as tlog:
        tout = scenario(T, td)
    jf, tf = _flat(jout), _flat(tout)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert jf[k].shape == tf[k].shape and np.array_equal(jf[k], tf[k]), k
    assert _costs(jlog) == _costs(tlog)
    return tout, _costs(tlog)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "pay": _u32(rng, (N, 3)), "pay1": _u32(rng, (N, 1)), "pay2": _u32(rng, (N, 2)),
        "dest": np.zeros(N, np.int32), "valid": rng.random(N) < 0.85,
        "keys": rng.permutation(1 << 20)[:N].astype(np.uint32) * np.uint32(2654435761),
        "keys2": rng.permutation(1 << 20)[:N].astype(np.uint32) * np.uint32(40503) + 7,
        "vals": _u32(rng, N), "v2": _u32(rng, (N, 2)),
    }


# --------------------------------------------------------------------------
# plain versions of the three kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("m,lanes", [(1, 1), (37, 3), (500, 4), (2100, 2)])
def test_mix_rows_matches_jax(impl, m, lanes):
    rng = np.random.default_rng(m + lanes)
    rows = _u32(rng, (m, lanes))
    rows[1::5, 0] |= np.uint32(1 << 31)
    rows[::7] = 0                                     # all-zero rows hash to 0
    want = np.asarray(jops.mix_rows(jnp.asarray(rows), impl=impl))
    got = tops.mix_rows(_t(rows)).numpy().view(np.uint32)
    assert np.array_equal(want, got)
    assert not got[::7].any()


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n,nbins,frac", [(1, 1, 1.0), (300, 7, 0.7), (2500, 33, 0.5),
                                          (64, 4, 0.0)])
def test_bin_histogram_matches_jax(impl, n, nbins, frac):
    rng = np.random.default_rng(n + nbins)
    bins = rng.integers(0, nbins, n).astype(np.int32)
    valid = rng.random(n) < frac
    want = np.asarray(jops.bin_histogram(jnp.asarray(bins), nbins, jnp.asarray(valid),
                                         impl=impl))
    got = tops.bin_histogram(_t(bins), nbins, _t(valid))
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(got.numpy(), tref.bin_histogram_ref(_t(bins), nbins,
                                                              _t(valid)).numpy())


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_ragged_and_stage_slots_match_jax(impl, rnd):
    rng = np.random.default_rng(rnd)
    n, nprocs, caps, roww, rounds = 400, 3, [7, 12, 5], [2, 4, 3], [3, 2, 1]
    flow = rng.integers(0, 3, n).astype(np.int32)
    bins = rng.integers(0, nprocs, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    offs = np.asarray(jops.multi_bin_offsets(jnp.asarray(bins), jnp.asarray(flow),
                                             nprocs, 3, jnp.asarray(valid))[1])
    wtot = sum(c * w for c, w in zip(caps, roww))
    tabs = [np.array(t, np.int32) for t in ([0, 14, 62], roww, caps, rounds)]
    sentinel = nprocs * wtot
    args = (bins, flow, offs, valid)
    want = jops.ragged_slots(*map(jnp.asarray, args), rnd, *map(jnp.asarray, tabs), wtot,
                             sentinel, impl=impl)
    got = tops.ragged_slots(*map(_t, args), rnd, *map(_t, tabs), wtot, sentinel)
    assert np.array_equal(np.asarray(want), got.numpy())
    live = np.array([1, 0, 1], np.int32)
    want = jops.stage_slots(*map(jnp.asarray, args), *map(jnp.asarray, tabs[:3]),
                            jnp.asarray(live), wtot, sentinel, impl=impl)
    got = tops.stage_slots(*map(_t, args), *map(_t, tabs[:3]), _t(live), wtot, sentinel)
    assert np.array_equal(np.asarray(want), got.numpy())
    shipped = got.numpy()[got.numpy() < sentinel]
    assert len(np.unique(shipped)) == len(shipped)


# --------------------------------------------------------------------------
# the exchange: integrity, faults, dead ranks, FINE, split phase, hier
# --------------------------------------------------------------------------

def _plan(X, d, transport=None, integrity=False, dead=None, max_rounds=2,
          async_=False, fine=False, overflow="drop"):
    """Three flows (two replying), committed and finished; every view,
    reply, leftover and unreachable mask comes back."""
    plan = X.ex.ExchangePlan(name="plan", promise=X.Promise.FINE if fine
                             else X.Promise.NONE)
    h0 = plan.add(d["pay"], d["dest"], 20, reply_lanes=2, valid=d["valid"],
                  op_name="f0")
    h1 = plan.add(d["pay1"], d["dest"], 25, reply_lanes=1, op_name="f1")
    h2 = plan.add(d["pay2"], d["dest"], 50, op_name="f2")
    kw = dict(impl=X.impl, max_rounds=max_rounds, transport=transport,
              dead_ranks=dead, integrity=integrity, overflow=overflow)
    c = (plan.commit_async(X.bk, **kw).finish(X.bk) if async_
         else plan.commit(X.bk, **kw))
    out = {}
    for h in (h0, h1, h2):
        v = c.view(h)
        out[f"view{h}"] = (v.payload, v.valid, v.src_rank, v.src_pos, v.dropped,
                           v.send_item, v.send_occ, v.lost)
        out[f"left{h}"] = c.leftover(h)[1]
        out[f"unreach{h}"] = c.unreachable(h)[1]
    c.set_reply(h0, c.view(h0).payload[:, :2] ^ 5)
    c.set_reply(h1, c.view(h1).payload)
    outs = c.finish(X.bk)
    out["replies"] = (outs[h0], outs[h1])
    return out


FAULTS = {
    "corrupt_round0": {"seed": 7, "corrupt": ((0, 0, 0),)},
    "corrupt_round1": {"seed": 3, "corrupt": ((1, 0, 0),)},
    "drop_round1": {"drop": ((1, 0, 0),)},
    "kill": {"kill_ranks": (0,), "kill_from_launch": 1},
    "corrupt_reply": {"seed": 5, "corrupt": ((2, 0, 0),)},
}


@pytest.mark.parametrize("fault,transport", [
    ("corrupt_round0", "dense"), ("drop_round1", "dense"), ("kill", "dense"),
    ("corrupt_reply", "dense"), ("corrupt_round1", "hier"), ("kill", "hier")])
def test_integrity_under_faults_matches_jax(fault, transport):
    def sc(X, d):
        inner = X.core.make_transport(transport)
        tr = X.core.FaultInjectingTransport(inner, X.core.FaultSpec(**FAULTS[fault]))
        out = _plan(X, d, transport=tr, integrity=True)
        out["launches"] = np.int32(tr.launches)
        return out

    out, _ = _run_both(sc, _data(1))
    lost = [int(out[f"view{h}"][7]) for h in range(3)]
    if fault == "corrupt_reply":
        assert lost == [0, 0, 0]
    else:
        assert sum(lost) > 0


def test_integrity_pallas_matches_jax():
    """The same integrity flow through the JAX package's Pallas kernels."""
    def sc(X, d):
        tr = X.core.FaultInjectingTransport(X.core.make_transport("dense"),
                                            X.core.FaultSpec(**FAULTS["corrupt_round1"]))
        return _plan(X, d, transport=tr, integrity=True)

    _run_both(sc, _data(2), impl="pallas")


@pytest.mark.parametrize("variant", ["dead", "fine", "fine_integrity", "async_dense",
                                     "async_hier", "async_integrity", "hier_carry"])
def test_plan_variants_match_jax(variant):
    kw = {"dead": dict(dead=(0,)), "fine": dict(fine=True),
          "fine_integrity": dict(fine=True, integrity=True, transport="hier"),
          "async_dense": dict(async_=True, max_rounds=3),
          "async_hier": dict(async_=True, transport="hier", max_rounds=3),
          "async_integrity": dict(async_=True, integrity=True, transport="hier"),
          "hier_carry": dict(transport="hier", overflow="carry")}[variant]
    out, log = _run_both(lambda X, d: _plan(X, d, **kw), _data(3))
    if variant == "dead":
        assert log["plan"]["unreachable"] == 1 and log["plan"]["lost_bytes"] > 0
        assert not out["view0"][1].any() and out["unreach0"].any()
    if variant.startswith("async"):
        assert log["plan"]["overlap_launches"] == kw.get("max_rounds", 2)
        # split-phase equals the synchronous commit, bit for bit
        sync = _plan(_pkg(True), {k: _t(v) for k, v in _data(3).items()},
                     **{**kw, "async_": False})
        a, b = _flat(out), _flat(sync)
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_hier_byte_pins_and_dense_parity():
    """test_wire_format's hierarchical hop and byte pins as cost-log
    equality with the JAX package, and hier == dense for the hash map."""
    def pins(X, d):
        plan = X.ex.ExchangePlan(name="op")
        h = plan.add(d["pay"][:12], d["dest"][:12], 16, reply_lanes=2, op_name="op")
        c = plan.commit(X.bk, transport=X.core.HierarchicalTransport())
        c.set_reply(h, c.view(h).payload[:, :2])
        return c.finish(X.bk)

    _, log = _run_both(pins, _data(4))
    c1 = c2 = 12
    w1 = 3 + 2
    assert log["op"]["bytes_out"] == c1 * w1 * 4
    assert log["op.relay"]["bytes_out"] == c2 * w1 * 4
    assert log["op"]["bytes_in"] == c1 * 2 * 4 and log["op.relay"]["bytes_in"] == c2 * 2 * 4
    assert log["op"]["collectives"] == 4 and log["op"]["hops"] == 4

    def hm_ops(X, d, transport):
        spec, st = X.hashmap(512, 8)
        st, ok = X.hm.insert(X.bk, spec, st, d["keys"], d["vals"], capacity=N,
                             transport=transport)
        st, v, f = X.hm.find(X.bk, spec, st, d["keys2"], capacity=N, transport=transport)
        return {"state": st, "ok": ok, "v": v, "f": f}

    out, _ = _run_both(lambda X, d: hm_ops(X, d, "hier"), _data(4))
    T = _pkg(True)
    dense = hm_ops(T, {k: _t(v) for k, v in _data(4).items()}, None)
    a, b = _flat(out), _flat(dense)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_hashmap_integrity_heal_and_degraded_match_jax():
    """micro_hashmap's faults arm: corrupt + integrity, heal, degraded probe."""
    def sc(X, d):
        spec, st = X.hashmap(512, 8)
        tr = X.core.FaultInjectingTransport(X.core.make_transport("dense"),
                                            X.core.FaultSpec(seed=7, corrupt=((0, 0, 0),)))
        st, ok1 = X.hm.insert(X.bk, spec, st, d["keys"], d["vals"], capacity=16,
                              max_rounds=4, attempts=1, transport=tr, integrity=True)
        st, ok2 = X.hm.insert(X.bk, spec, st, d["keys"], d["vals"], capacity=16,
                              max_rounds=4, valid=~ok1, attempts=1, integrity=True)
        st2, ok3 = X.hm.insert(X.bk, spec, st, d["keys"][:8], d["vals"][:8], capacity=8,
                               attempts=1, dead_ranks=(0,))
        st, v, f = X.hm.find(X.bk, spec, st, d["keys"], capacity=N)
        return {"state": st, "state2": st2, "ok1": ok1, "ok2": ok2, "ok3": ok3,
                "v": v, "f": f}

    out, log = _run_both(sc, _data(5))
    ok1, ok2 = out["ok1"].numpy(), out["ok2"].numpy()
    assert (~ok1).sum() == 16 and not ok1[:16].any() and ok1[16:].all()
    assert ok2[~ok1].all() and out["f"].all() and not out["ok3"].any()
    assert log["hashmap.insert"]["unreachable"] == 1


# --------------------------------------------------------------------------
# containers: async_=True equals the sync op and the JAX package's
# --------------------------------------------------------------------------

def sc_hashmap_find_insert(X, d, async_, transport="hier"):
    spec, st = X.hashmap(512, 8)
    st, _ = X.hm.insert(X.bk, spec, st, d["keys"], d["vals"], capacity=N)
    kw = dict(capacity=N, transport=transport, max_rounds=2)
    out = X.hm.find_insert(X.bk, spec, st, d["keys2"], d["keys2"], d["vals"], async_=async_,
                           **kw)
    fine = X.hm.find_insert(X.bk, spec, st, d["keys"], d["keys2"], d["vals"],
                            promise=X.P.HashMap.find_insert | X.P.FINE, async_=async_, **kw)
    return out.finish() if async_ else out, fine.finish() if async_ else fine


def sc_queue_push_pop(X, d, async_, transport="hier"):
    spec, st = X.queue(64)
    st, _, _ = X.q.push(X.bk, spec, st, d["v2"][:20], d["dest"][:20], capacity=20)
    outs = []
    for overflow in ("drop", "carry"):
        r = X.q.push_pop(X.bk, spec, st, d["v2"], d["dest"], 30, 25, 0, overflow=overflow,
                         transport=transport, async_=async_)
        outs.append(r.finish() if async_ else r)
    return outs


def sc_bloom_insert_find(X, d, async_, transport="hier"):
    spec, st = X.bloom(1 << 10)
    r = X.bl.insert_find(X.bk, spec, st, d["v2"], d["v2"][N // 3:], N, N,
                         transport=transport, async_=async_)
    return r.finish() if async_ else r


def sc_buffer_spill_flush(X, d, async_, transport="hier"):
    mspec, mst = X.hashmap(512, 8)
    spec, st = X.hb.create(X.bk, mspec, mst, queue_capacity=48, buffer_cap=N)
    st, _ = X.hb.insert(spec, st, d["keys"], d["vals"])
    r = X.hb.spill(X.bk, spec, st, capacity=32, overflow="carry", transport=transport,
                   async_=async_)
    st, dropped = r.finish() if async_ else r
    r = X.hb.flush(X.bk, spec, st, capacity=N, transport=transport, async_=async_)
    st2, dropped2 = r.finish() if async_ else r
    return {"spilled": st, "dropped": dropped, "flushed": st2, "dropped2": dropped2}


CONTAINER_SCENARIOS = {f.__name__[3:]: f for f in (
    sc_hashmap_find_insert, sc_queue_push_pop, sc_bloom_insert_find, sc_buffer_spill_flush)}


@pytest.mark.parametrize("name", sorted(CONTAINER_SCENARIOS))
def test_container_async_matches_sync_and_jax(name):
    scenario = CONTAINER_SCENARIOS[name]
    out, log = _run_both(lambda X, d: scenario(X, d, True), _data(6))
    T = _pkg(True)
    with tcosts.recording() as slog:
        sync = scenario(T, {k: _t(v) for k, v in _data(6).items()}, False)
    a, b = _flat(out), _flat(sync)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    # every cost column equal but overlap_launches, which only async records
    assert any(c["overlap_launches"] > 0 for c in log.values())
    strip = lambda lg: {k: {f: v for f, v in c.items() if f != "overlap_launches"}
                        for k, c in lg.items()}
    assert strip(log) == strip(_costs(slog))


def test_extension_options_validate():
    bk = TSerial()
    x = torch.zeros((4, 1), dtype=torch.int32)
    d = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        tex.route(bk, x, d, 4, dead_ranks=(1,))
    with pytest.raises(ValueError, match="unknown transport"):
        tex.route(bk, x, d, 4, transport="mesh")
    with pytest.raises(ValueError, match="does not factor"):
        tex.route(bk, x, d, 4, transport=tcore.HierarchicalTransport(pr=2))
    with pytest.raises(ValueError, match="hop lane"):
        tex.route(bk, torch.zeros((1 << 20, 1), dtype=torch.int32),
                  torch.zeros(1 << 20, dtype=torch.int32), 1 << 20, transport="hier")
    req = tex.route(bk, x, d, 4)
    with pytest.raises(ValueError, match="finish"):
        tex.reply(bk, req, x, 4, transport="hier")
    plan = tex.ExchangePlan()
    plan.add(x, d, 4)
    pend = plan.commit_async(bk)
    pend.finish(bk)
    with pytest.raises(ValueError, match="already finished"):
        pend.finish(bk)
    with pytest.raises(ValueError, match="partition"):
        bk.tiled_all_to_all(x, groups=[[0], [1]])
