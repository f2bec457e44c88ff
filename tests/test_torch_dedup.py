"""The port's LM-data dedup and token stream against the JAX package.

``repro_torch.data.Deduper`` runs on a ``SerialBackend`` with the plain
versions on the CPU, JAX's ``repro.data.dedup.Deduper`` beside it on the
same numpy documents (one ``DedupSpec`` shape, ngram 4 over (4, 64)
documents, in one module-scope fixture; the JAX Deduper's container
calls jitted, each signature compiled once), at ``max_rounds`` 1 and 4:
two ``observe`` calls, an ``observe_and_probe`` and a ``count_of``.
Every output is integer or an exact float64 ratio, so the tolerance is
0: the shingles, verdicts, ``dup_frac``, probe fractions and counts, the
Bloom words, the hash-map arrays and the cost log's collectives, bytes
and rounds by op, bit for bit.  JAX's six behavioural cases (``tests/test_dedup.py``) then run on
the port alone, and ``TokenStream`` / ``synth_batch`` (numpy generation
in both packages) must give JAX's arrays.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs import shapes as jshapes
from repro.core import costs as jcosts
from repro.core import get_backend
from repro.data import dedup as jdedup
from repro.data import tokens as jtokens
from repro_torch import configs as tcfg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import costs
from repro_torch.core.backend import SerialBackend
from repro_torch.data import Deduper, DedupSpec, TokenStream, synth_batch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NGRAM, DOCS = 4, (4, 64)
ROUNDS = (1, 4)
COST_FIELDS = ("collectives", "bytes_out", "bytes_in", "rounds")



def _corpus() -> dict:
    """One document shape: a batch, a second batch of two verbatim copies
    and two half copies, a probe of two observed and two fresh documents."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1000, DOCS).astype(np.int32)
    b = a.copy()
    b[2:, DOCS[1] // 2:] = rng.integers(1000, 2000, (2, DOCS[1] // 2))
    c = rng.integers(2000, 3000, DOCS).astype(np.int32)
    c[0] = a[1]
    probe = np.concatenate([a[[0, 3]], rng.integers(5000, 6000, (2, DOCS[1]))]).astype(np.int32)
    return {"a": a, "b": b, "c": c, "probe": probe}


def _drive(d, docs: dict) -> dict:
    """The op sequence on either package's Deduper; results as numpy."""
    out = {}
    out["obs1"] = d.observe(docs["a"])
    out["obs2"] = d.observe(docs["b"])
    out["oap"] = d.observe_and_probe(docs["c"], docs["probe"])
    out["count"] = (d.count_of(docs["a"]),)
    return {k: tuple(x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                     for x in v) for k, v in out.items()}


def _cost_summary(log) -> dict:
    return {op: {f: getattr(log.by_op(op), f) for f in COST_FIELDS}
            for op in sorted({n for n, _ in log.entries})}


def _words(x) -> np.ndarray:
    """Any 32-bit word array, as int32 bits in one flat row."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32).reshape(-1)


def _jitted(fn):
    """``fn(backend, spec, state, *arrays, **kw)``, a container call, under
    ``jax.jit``: one XLA compile per call signature where JAX's eager first
    calls compile every primitive apart (the first ``observe`` took 27 s
    eagerly, the whole fixture 9 s jitted; results and cost logs equal).
    JAX records costs at trace time, so the entries a signature's trace
    recorded are recorded again on each call that reuses it."""
    compiled = {}

    def call(backend, spec, state, *args, **kw):
        arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
        static = {k: v for k, v in kw.items() if k not in arrays}
        shapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), (state, args, arrays))
        key = (id(backend), id(spec), tuple(sorted(static.items())), repr(shapes))
        if key not in compiled:
            compiled[key] = (jax.jit(lambda st, a, ak: fn(backend, spec, st, *a, **ak, **static)),
                             [])
        f, entries = compiled[key]
        with jcosts.recording() as log:
            out = f(state, args, arrays)
        if log.entries:                       # traced now
            entries[:] = log.entries
        for op, cost in entries:
            jcosts.record(op, cost)
        return out
    return call


@pytest.fixture(scope="module")
def runs():
    """Both packages' Dedupers through ``_drive``; the JAX Deduper's
    container calls (``bl.insert``, ``bl.insert_find``, ``hm.insert``,
    ``hm.find``, as ``repro.data.dedup`` reaches them) jitted."""
    docs = _corpus()
    out = {}
    real = {"bl": jdedup.bl, "hm": jdedup.hm}
    jdedup.bl = types.SimpleNamespace(**{**vars(real["bl"]), **{
        name: _jitted(getattr(real["bl"], name)) for name in ("insert", "insert_find")}})
    jdedup.hm = types.SimpleNamespace(**{**vars(real["hm"]), **{
        name: _jitted(getattr(real["hm"], name)) for name in ("insert", "find")}})
    try:
        for r in ROUNDS:
            j = jdedup.Deduper(get_backend(None), jdedup.DedupSpec(ngram=NGRAM, max_rounds=r))
            t = Deduper(SerialBackend(), DedupSpec(ngram=NGRAM, max_rounds=r), device="cpu",
                        impl="torch")
            with jcosts.recording() as jlog:
                jres = _drive(j, docs)
            with costs.recording() as tlog:
                tres = _drive(t, docs)
            out[r] = dict(jax=j, torch=t, jres=jres, tres=tres, jcost=_cost_summary(jlog),
                          tcost=_cost_summary(tlog))
    finally:
        jdedup.bl, jdedup.hm = real["bl"], real["hm"]
    return docs, out


def test_shingles_match_jax(runs):
    docs, out = runs
    j, t = out[1]["jax"], out[1]["torch"]
    for name in ("a", "b", "probe"):
        want, got = j.shingles(docs[name]), t.shingles(docs[name])
        for lane in ("hi", "lo"):
            assert got[lane].dtype == torch.int32
            assert np.array_equal(got[lane].numpy().view(np.uint32), np.asarray(want[lane]))
    # token values past 2**31 (uint32) and negative ones (int32), as tensors
    big = np.random.default_rng(1).integers(0, 1 << 32, (3, 40), dtype=np.uint64)
    for toks in (big.astype(np.uint32), big.astype(np.uint32).view(np.int32)):
        want, got = j.shingles(toks), t.shingles(torch.from_numpy(toks))
        for lane in ("hi", "lo"):
            assert np.array_equal(got[lane].numpy().view(np.uint32), np.asarray(want[lane]))


@pytest.mark.parametrize("rounds", ROUNDS)
def test_verdicts_match_jax(runs, rounds):
    """dup_frac (float64), is_duplicate, probe fractions and counts."""
    _, out = runs
    jres, tres = out[rounds]["jres"], out[rounds]["tres"]
    for op in jres:
        for want, got in zip(jres[op], tres[op], strict=True):
            if op == "count":
                want = want.astype(np.int64)
            assert got.dtype == want.dtype and got.shape == want.shape, (op, got.dtype)
            assert np.array_equal(got, want), (op, got, want)
    # the run is not vacuous: verbatim copies flagged, half copies not,
    # the probe's observed half seen; the documents observed twice and
    # three times count 2 and 3, first halves seen twice too
    assert jres["obs2"][1].tolist() == [True, True, False, False]
    assert jres["oap"][2].tolist() == [1.0, 1.0, 0.0, 0.0]
    count = jres["count"][0]
    assert (count[0] == 2).all() and (count[1] == 3).all() and (count[2:, :28] == 2).all()


@pytest.mark.parametrize("rounds", ROUNDS)
def test_filter_and_table_match_jax(runs, rounds):
    _, out = runs
    j, t = out[rounds]["jax"], out[rounds]["torch"]
    assert np.array_equal(_words(t.bstate.words), _words(j.bstate.words))
    for f in ("tkeys", "tvals", "status"):
        assert np.array_equal(_words(getattr(t.hstate, f)), _words(getattr(j.hstate, f))), f
    assert (np.asarray(j.hstate.status) & 3 == 2).sum() > 0


@pytest.mark.parametrize("rounds", ROUNDS)
def test_cost_log_matches_jax(runs, rounds):
    """Collectives, bytes and rounds by op, retry rounds included."""
    _, out = runs
    assert out[rounds]["tcost"] == out[rounds]["jcost"]
    assert ("bloom.insert.retry" in out[rounds]["tcost"]) == (rounds > 1)


# -- JAX's behavioural cases (tests/test_dedup.py), on the port alone --------

def _deduper(**kw) -> Deduper:
    return Deduper(SerialBackend(), DedupSpec(**kw), device="cpu")


def exact_duplicates_flagged(rng):
    d = _deduper(ngram=4, dup_threshold=0.5)
    docs = rng.integers(0, 1000, (4, 64)).astype(np.int32)
    frac1, dup1 = d.observe(docs)
    assert not dup1.any()                      # first sighting: fresh
    frac2, dup2 = d.observe(docs.copy())       # resubmitted verbatim
    assert dup2.all()
    assert (frac2 > 0.95).all()


def fresh_docs_pass(rng):
    d = _deduper(ngram=4)
    a = rng.integers(0, 10000, (4, 64)).astype(np.int32)
    b = rng.integers(10000, 20000, (4, 64)).astype(np.int32)
    d.observe(a)
    frac, dup = d.observe(b)
    assert not dup.any()
    assert (frac < 0.1).all()


def partial_overlap_measured(rng):
    d = _deduper(ngram=4, dup_threshold=0.4)
    base = rng.integers(0, 1000, (1, 64)).astype(np.int32)
    d.observe(base)
    half = base.copy()
    half[0, 32:] = rng.integers(2000, 3000, 32)
    frac, dup = d.observe(half)
    assert 0.25 < frac[0] < 0.75


def observe_and_probe_fused_pair(rng):
    """The contamination-check path: bloom insert + find share one plan
    (2 collectives), and the probe sees this batch's insertions."""
    d = _deduper(ngram=4)
    train = rng.integers(0, 1000, (2, 64)).astype(np.int32)
    with costs.recording() as log:
        frac, dup, probe_frac = d.observe_and_probe(train, train.copy())
    assert log.by_op("bloom.insert_find").collectives == 2
    assert not dup.any()
    assert (probe_frac > 0.95).all()
    nxt = rng.integers(2000, 3000, (2, 64)).astype(np.int32)
    fresh = rng.integers(5000, 9000, (2, 64)).astype(np.int32)
    _, _, pf = d.observe_and_probe(nxt, fresh)
    assert (pf < 0.1).all()
    _, _, pf2 = d.observe_and_probe(rng.integers(3000, 4000, (2, 64)).astype(np.int32), train)
    assert (pf2 > 0.95).all()


def counts_accumulate(rng):
    d = _deduper(ngram=4)
    doc = rng.integers(0, 500, (1, 32)).astype(np.int32)
    for _ in range(3):
        d.observe(doc)
    counts = d.count_of(doc)
    # seen 3 times: bloom ate the 1st, table counted the next 2 (+1 base)
    assert (counts >= 3).all()


def retry_rounds_same_results_fraction_of_wire(rng):
    """max_rounds=R sizes each launch at ceil(m/R) wire rows: identical
    verdicts, each launch an R-fold narrower footprint."""
    docs = rng.integers(0, 1000, (4, 64)).astype(np.int32)
    outs, byts = [], []
    for r in (1, 4):
        d = _deduper(ngram=4, dup_threshold=0.5, max_rounds=r)
        with costs.recording() as log:
            frac1, dup1 = d.observe(docs)
            frac2, dup2 = d.observe(docs.copy())
        outs.append((frac1, dup1, frac2, dup2))
        byts.append(log.by_op("bloom.insert").bytes_out)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert byts[1] * 3 < byts[0]


BEHAVIOUR = (exact_duplicates_flagged, fresh_docs_pass, partial_overlap_measured,
             observe_and_probe_fused_pair, counts_accumulate,
             retry_rounds_same_results_fraction_of_wire)


@pytest.mark.parametrize("case", BEHAVIOUR, ids=lambda f: f.__name__)
def test_dedup_behaviour(case, rng):
    case(rng)


# -- the token stream and synthetic batches ----------------------------------

def test_token_stream_matches_jax():
    """Two shards, two steps, after a state round trip."""
    kw = dict(vocab=1000, seq_len=96, global_batch=4, seed=3)
    j, t = jtokens.TokenStream(**kw), TokenStream(**kw)
    j.next_batch()
    t.load_state_dict(j.state_dict())
    assert t.state_dict() == j.state_dict() == {"step": 1, "seed": 3}
    for step in (1, 2):
        for shard in range(2):
            j.step = t.step = step
            want, got = j.next_batch(2, shard), t.next_batch(2, shard, device="cpu")
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == torch.from_numpy(want[k]).dtype
                assert np.array_equal(got[k].numpy(), want[k]), k
    assert t.step == j.step == 3
    with pytest.raises(ValueError):
        t.next_batch(3, 0, device="cpu")


def test_shapes_match_jax():
    assert {k: vars(v) for k, v in tshapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jshapes.SHAPES.items()}
    for arch in tcfg.ARCH_IDS:
        for name, shape in tshapes.SHAPES.items():
            assert tshapes.shape_applicable(tcfg.get_config(arch), shape) == \
                jshapes.shape_applicable(jcfg.get_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-76b", "seamless-m4t-medium"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_synth_batch_matches_jax(arch, shape):
    """Text, patch and frame frontends, train and decode kinds."""
    jc, tc = jcfg.reduced(jcfg.get_config(arch)), tcfg.reduced(tcfg.get_config(arch))
    want = jtokens.synth_batch(jc, jshapes.SHAPES[shape], np.random.default_rng(7), 2)
    got = synth_batch(tc, tshapes.SHAPES[shape], np.random.default_rng(7), 2, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.ascontiguousarray(want[k])).dtype
        assert np.array_equal(got[k].numpy(), want[k]), k
