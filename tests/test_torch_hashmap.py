"""The port's hash map and exchange against the JAX package at P=1.

Both packages start from the same populated table (carried across with
``repro_torch.interop``), run the same op sequence on the same numpy
inputs over a ``SerialBackend``, and must agree bit for bit: table
arrays, successes, found flags, values, drop counts and send maps, and
every field of the cost log per op name.  The JAX side runs each
scenario under a fresh ``jax.jit`` inside ``costs.recording()`` (JAX
records costs at trace time), once with ``impl="jnp"`` and once with
the Pallas kernels in interpret mode; the port runs its plain versions
on the CPU.  Batches stay within the Pallas probe's per-block capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ShapeDtypeStruct as SDS

from repro.containers import hashmap as jhm
from repro.core import costs as jcosts
from repro.core import exchange as jex
from repro.core.backend import SerialBackend as JSerial
from repro.core.promises import ConProm as JConProm
from repro_torch import interop
from repro_torch.containers import hashmap as thm
from repro_torch.core import costs as tcosts
from repro_torch.core import exchange as tex
from repro_torch.core.backend import SerialBackend as TSerial
from repro_torch.core.object_container import Spec
from repro_torch.core.promises import ConProm as TConProm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CAP, BLOCK = 512, 8          # 64 blocks of 8
N = 96                       # batch per op


def _data(seed):
    rng = np.random.default_rng(seed)
    pool = rng.permutation(1 << 22)[:4 * N].astype(np.uint32) * np.uint32(977)
    pool[: N // 4] |= np.uint32(1 << 31)            # keys >= 2**31 ride along
    keys = pool[:N].copy()
    keys[-8:] = keys[:8]                             # in-batch duplicates
    q = np.concatenate([pool[N // 2:N + N // 2], pool[2 * N:2 * N + N // 2]])[:N]
    return {
        "pre": pool[3 * N:4 * N],
        "keys": keys, "vals": rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32),
        "q": q, "fk": pool[:N], "ik": pool[N:2 * N],
        "iv": rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32),
        "mask": rng.random(N) < 0.9,
    }


# Each scenario runs against either package: ``hm`` is the container
# module, ``P`` its ConProm, ``d`` the inputs as that package's arrays.
def sc_insert_a1(hm, P, bk, spec, st, d):
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=N, attempts=1)
    return {"state": st, "ok": ok}


def sc_insert_a2_rounds2(hm, P, bk, spec, st, d):
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=N // 3,
                       attempts=2, max_rounds=2, valid=d["mask"])
    return {"state": st, "ok": ok}


def sc_insert_drops(hm, P, bk, spec, st, d):
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=N // 4,
                       attempts=2, max_rounds=1)
    return {"state": st, "ok": ok}


def sc_insert_add_keep(hm, P, bk, spec, st, d):
    st, ok1 = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=N, mode=1,
                        promise=P.HashMap.insert)
    st, ok2 = hm.insert(bk, spec, st, d["keys"], d["iv"], capacity=N, mode=2)
    return {"state": st, "ok1": ok1, "ok2": ok2}


def sc_find_speculative(hm, P, bk, spec, st, d):
    st, v, f = hm.find(bk, spec, st, d["q"], capacity=N, valid=d["mask"])
    return {"state": st, "vals": v, "found": f}


def sc_find_sequential(hm, P, bk, spec, st, d):
    st, v, f = hm.find(bk, spec, st, d["q"], capacity=N, speculative=False)
    st, v1, f1 = hm.find(bk, spec, st, d["q"], capacity=N, attempts=1,
                         promise=P.HashMap.find)
    return {"state": st, "vals": v, "found": f, "vals1": v1, "found1": f1}


def sc_find_insert(hm, P, bk, spec, st, d):
    st, v, f, ok = hm.find_insert(bk, spec, st, d["fk"], d["ik"], d["iv"], capacity=N)
    st, v2, f2 = hm.find(bk, spec, st, d["ik"], capacity=N)
    return {"state": st, "vals": v, "found": f, "ok": ok, "vals2": v2, "found2": f2}


def sc_find_insert_fine(hm, P, bk, spec, st, d):
    st, v, f, ok = hm.find_insert(bk, spec, st, d["fk"], d["ik"], d["iv"], capacity=N,
                                  promise=P.HashMap.find_insert | P.FINE)
    return {"state": st, "vals": v, "found": f, "ok": ok}


def sc_count_resize(hm, P, bk, spec, st, d):
    st, _ = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=N)
    _, st2 = hm.resize(bk, spec, st, 2 * CAP, 2 * CAP)
    return {"state": st2, "count": hm.count_ready(bk, st), "count2": hm.count_ready(bk, st2)}


def sc_local_insert_find(hm, P, bk, spec, st, d):
    """The local promise: the column front ends of the probe, no exchange."""
    st, ok = hm.insert(bk, spec, st, d["keys"], d["vals"], capacity=1,
                       promise=P.HashMap.local, valid=d["mask"], mode=1)
    st, ok2 = hm.insert(bk, spec, st, d["ik"], d["iv"], capacity=1,
                        promise=P.HashMap.local, mode=2)
    st, v, f = hm.find(bk, spec, st, d["q"], capacity=1, promise=P.HashMap.local,
                       valid=d["mask"])
    return {"state": st, "ok": ok, "ok2": ok2, "vals": v, "found": f}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_local_insert_find, sc_insert_a1, sc_insert_a2_rounds2, sc_insert_drops, sc_insert_add_keep,
    sc_find_speculative, sc_find_sequential, sc_find_insert, sc_find_insert_fine,
    sc_count_resize)}


@pytest.fixture(scope="module")
def populated():
    """A table populated by the JAX package, exported as u32 numpy."""
    d = _data(0)
    bk = JSerial()
    spec, st = jhm.hashmap_create(bk, CAP, SDS((), jnp.uint32), SDS((), jnp.uint32),
                                  block_size=BLOCK, impl="jnp")
    st, ok = jax.jit(lambda st, k, v: jhm.insert(bk, spec, st, k, v, capacity=N))(
        st, jnp.asarray(d["pre"]), jnp.asarray(d["pre"] + 1))
    assert bool(ok.all())
    return {k: np.asarray(v) for k, v in jhm.export_state(spec, st).items()}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _costs(log):
    names = sorted({name for name, _ in log.entries})
    return {name: log.by_op(name).__dict__ for name in names}


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hashmap_matches_jax(populated, name, impl):
    scenario = SCENARIOS[name]
    d = _data(1)

    jb = JSerial()
    jspec, _ = jhm.hashmap_create(jb, CAP, SDS((), jnp.uint32), SDS((), jnp.uint32),
                                  block_size=BLOCK, impl=impl)
    jst = jhm.restore_state(jspec, populated)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    with jcosts.recording() as jlog:
        jout = jax.jit(lambda st, dd: scenario(jhm, JConProm, jb, jspec, st, dd))(jst, jd)

    tb = TSerial()
    tspec, _ = thm.hashmap_create(tb, CAP, Spec((), torch.uint32), Spec((), torch.uint32),
                                  block_size=BLOCK, impl="torch", device="cpu")
    tst = interop.hashmap_state_from_numpy(populated, device="cpu")
    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    with tcosts.recording() as tlog:
        tout = scenario(thm, TConProm, tb, tspec, tst, td)

    assert sorted(jout) == sorted(tout)
    jstate = {k: np.asarray(getattr(jout["state"], k)) for k in ("tkeys", "tvals", "status")}
    tstate = interop.hashmap_state_to_numpy(tout["state"])
    for k in jstate:
        assert np.array_equal(jstate[k], tstate[k]), f"{name}: table {k}"
    for k in sorted(set(jout) - {"state"}):
        j, t = _as_np(jout[k]), _as_np(tout[k])
        if t.dtype != j.dtype and t.dtype.itemsize == j.dtype.itemsize:
            t = t.view(j.dtype)
        assert np.array_equal(j, t), f"{name}: {k}"
    assert _costs(jlog) == _costs(tlog), f"{name}: cost log"


@pytest.mark.parametrize("max_rounds,overflow", [(1, "drop"), (2, "carry"), (3, "drop")])
def test_route_reply_match_jax(max_rounds, overflow):
    """Owner views, drops, send maps, carry masks and replies of ``route``."""
    rng = np.random.default_rng(max_rounds)
    n, lanes, cap = 50, 3, 12
    pay = rng.integers(0, 1 << 32, (n, lanes), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    dest = np.zeros(n, np.int32)

    def run(ex, bk, p, dst, v, rep):
        r = ex.route(bk, p, dst, cap, valid=v, max_rounds=max_rounds, overflow=overflow)
        back, answered = ex.reply(bk, r, rep(r.payload), n)
        return r, ex.carry_mask(r, v), back, answered

    with jcosts.recording() as jlog:
        jr, jc, jback, jans = run(jex, JSerial(), jnp.asarray(pay), jnp.asarray(dest),
                                  jnp.asarray(valid), lambda x: x[:, :2] ^ jnp.uint32(7))
    with tcosts.recording() as tlog:
        tr, tc, tback, tans = run(tex, TSerial(), torch.from_numpy(pay),
                                  torch.from_numpy(dest), torch.from_numpy(valid),
                                  lambda x: x[:, :2] ^ 7)
    for field in ("payload", "valid", "src_rank", "src_pos", "dropped", "send_item",
                  "send_occ"):
        j, t = np.asarray(getattr(jr, field)), getattr(tr, field).numpy()
        assert np.array_equal(j, t.view(j.dtype) if t.dtype != j.dtype else t), field
    assert jr.capacity == tr.capacity
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jback), tback.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jans), tans.numpy())
    assert _costs(jlog) == _costs(tlog)
    if max_rounds == 1:
        assert int(tr.dropped) > 0


def test_port_raises_on_unported_exchange_options():
    """Every exchange option is ported now: the extension knobs run, and
    what no package supports raises, naming the cause."""
    bk = TSerial()
    x = torch.zeros((4, 1), dtype=torch.int32)
    d = torch.zeros(4, dtype=torch.int32)
    for kw in ({"integrity": True}, {"dead_ranks": (0,)}, {"transport": "hier"}):
        assert tex.route(bk, x, d, 4, **kw).payload.shape == (4, 1)
    assert tex.ExchangePlan(promise=TConProm.FINE).promise == TConProm.FINE
    with pytest.raises(ValueError, match="unknown transport"):
        tex.route(bk, x, d, 4, transport="ring")
    with pytest.raises(tex.ExchangeOverflowError):
        tex.route(bk, x, d, 2, overflow="raise-in-test")
