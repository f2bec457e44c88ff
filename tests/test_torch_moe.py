"""The port's MoE dispatch (on the CPU, P=1) against the JAX package.

``repro_torch.models.moe.moe_apply`` on one rank with the
plain versions (``impl="torch"``) against ``repro.models.moe.moe_apply``
on a 1 x 1 mesh (its ``jnp`` path, under a fresh ``jax.jit`` so its
cost log is the trace-time log), at reduced arctic-480b (float32,
d_model 64, 8 experts, top-2, expert d_ff 64, the dense residual MLP)
with the JAX parameters carried across.  Each dispatch knob is a case:
the base path, one row per distinct owner (``moe_dedup_dispatch``),
split-phase (``moe_async_dispatch``), the bf16 wire payload, retry
rounds under a capacity that still drops, sigmoid routing with
``moe_bias`` and a shared expert, and a capacity whose expert bins drop
copies the wire admitted.  Tolerances: ``y`` within 1e-5 relative L2
(float32 products summed in another order), except the bf16 payload,
where the wire rounds each expert output to bf16 and a 1e-7 difference
can move an element by one bf16 ulp, so it is held elementwise within
2**-8 of each element; ``aux`` within 1e-6; ``expert_load``, the wire
drops, the wire words of ``_pack_act`` and the cost log exactly.  Every
input's top-k margin (k-th minus (k+1)-th score) is asserted above 1e-6,
so no tie decides a pick.

The slice as a whole: reduced arctic's ``lm.prefill`` and three decode
steps against the JAX ones (float32 logits within 1e-5 relative L2; a
bf16 case at 2e-2, whose routers' margins are asserted above 1e-2 so
that a bf16 rounding cannot flip a pick), ``serve.main --arch
arctic-480b --reduced --cpu``, the parameters' round trip through
``interop`` with each rank's expert slice, the int32 word-slot bounds
of the wire, and, at two model ranks, the gather of the ranks' dispatch
outputs in rank order, bit for bit in float32 and bf16.  The card runs the same path through the wire
kernels (``chip_smoke.py``'s MoE serving phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import costs as jcosts
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.sharding import Axes
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.core import costs as tcosts
from repro_torch.core.backend import SerialBackend
from repro_torch.core.transport import DENSE, FlowWire, HierarchicalTransport, _DenseCtx
from repro_torch.kernels import binning
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.sharding import Layout, shard_params
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARCH = "arctic-480b"
Y_REL_L2 = 1e-5
AUX_ATOL = 1e-6
LOGITS_REL_L2 = 1e-5
BF16_LOGITS_REL_L2 = 2e-2

#: dispatch knobs (ArchConfig fields; "moe": MoEConfig fields)
CASES = {
    "base": {},
    "dedup": dict(moe_dedup_dispatch=True),
    "async": dict(moe_async_dispatch=True),
    "bf16_payload": dict(moe_payload_dtype="bfloat16"),
    "rounds_drop": dict(moe_dispatch_rounds=2, moe_capacity_slack=0.4),
    "bias_shared": dict(moe=dict(shared_experts=1, bias_update_rate=0.01)),
    "bin_drop": dict(moe_capacity_slack=1.0),
}


def _cfgs(**over):
    mo = over.pop("moe", {})
    out = []
    for pkg in (jcfg, tcfg):
        cfg = pkg.reduced(pkg.get_config(ARCH), **over)
        if mo:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **mo))
        out.append(cfg)
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moe_params(cfg_j, cfg_t, seed):
    """JAX moe_init parameters (a nonzero ``moe_bias`` where there is one)
    and the same in the port."""
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    if "moe_bias" in pj:
        pj["moe_bias"] = jnp.asarray(
            np.random.default_rng(seed).normal(0, 0.05, cfg_j.moe.n_experts), jnp.float32)
    return pj, interop.tree_from_numpy(_np_tree(pj), "cpu")


def _cost_summary(log) -> dict:
    return {name: log.by_op(name).__dict__ for name in sorted({n for n, _ in log.entries})}


def _margins(params, x, cfg) -> torch.Tensor:
    """k-th minus (k+1)-th router score of every token."""
    k = cfg.moe.top_k
    s = tmoe.router_topk(params, x, cfg)[3].sort(dim=-1, descending=True).values
    return s[..., k - 1] - s[..., k]


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_jax(mesh11, case):
    cfg_j, cfg_t = _cfgs(**CASES[case])
    pj, pt = _moe_params(cfg_j, cfg_t, seed=0)
    x = np.random.default_rng(2).normal(size=(2, 12, cfg_j.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert float(_margins(pt, xt, cfg_t).min()) > 1e-6

    axes = Axes.from_mesh(mesh11)
    with jcosts.recording() as log_j:
        yj, auxj, sj = jax.jit(lambda p, xx: jmoe.moe_apply(p, xx, cfg_j, mesh11, axes))(
            pj, jnp.asarray(x))
    with tcosts.recording() as log_t:
        yt, auxt, st = tmoe.moe_apply(pt, xt, cfg_t, impl="torch")

    yj = np.asarray(yj)
    assert yt.shape == yj.shape and yt.dtype == torch.float32
    if cfg_t.moe_payload_dtype == "bfloat16":
        np.testing.assert_allclose(yt.numpy(), yj, rtol=2.0 ** -8, atol=1e-6)
    else:
        assert _rel_l2(yt.numpy(), yj) <= Y_REL_L2
    assert abs(float(auxt) - float(auxj)) <= AUX_ATOL
    load = st["expert_load"].numpy()
    assert np.array_equal(load, np.asarray(sj["expert_load"]))
    assert int(st["dispatch_dropped"]) == int(sj["dispatch_dropped"])
    assert _cost_summary(log_t) == _cost_summary(log_j)
    assert {"moe.dispatch", "moe.stats"} <= set(_cost_summary(log_t))

    n_copies = x.shape[0] * x.shape[1] * cfg_t.moe.top_k
    if case == "rounds_drop":           # retry rounds ran and the wire still dropped
        assert "moe.dispatch.retry" in _cost_summary(log_t)
        assert int(st["dispatch_dropped"]) > 0
    elif case == "bin_drop":            # the wire admitted every copy, the bins did not
        assert int(st["dispatch_dropped"]) == 0 and load.sum() < n_copies
    else:
        assert int(st["dispatch_dropped"]) == 0 and load.sum() == n_copies


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pack_act_words_match_jax(bf16):
    """The wire words of ``_pack_act`` are the JAX package's bit for bit
    (bf16: the even element in the low half), and unpack back."""
    x = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    want = np.asarray(jmoe._pack_act(jnp.asarray(x), bf16))
    got = tmoe._pack_act(torch.from_numpy(x), bf16)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)
    back = tmoe._unpack_act(got, bf16)
    assert np.array_equal(back.numpy(), np.asarray(jmoe._unpack_act(jnp.asarray(want), bf16)))
    if bf16:   # bf16(1.0) = 0x3F80 low, bf16(2.0) = 0x4000 high
        pair = tmoe._pack_act(torch.tensor([[1.0, 2.0]]), True)
        assert pair.numpy().view(np.uint32).tolist() == [[0x40003F80]]


def _lm_models(dtype, seed):
    over = {} if dtype == "float32" else {"dtype": dtype}
    cfg_j, cfg_t = _cfgs(**over)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, params_j, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t,
                                                                "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# (dtype, seed, batch, prompt, logits tolerance, smallest router margin)
LM_CASES = {"f32": ("float32", 1, 2, 24, LOGITS_REL_L2, 1e-6),
            # a seed whose routers all pick with margins above 1e-2 (asserted)
            "bf16": ("bfloat16", 10, 1, 6, BF16_LOGITS_REL_L2, 1e-2)}


@pytest.mark.parametrize("case", LM_CASES)
def test_lm_prefill_and_decode_match_jax(mesh11, monkeypatch, case):
    dtype, seed, b, t, tol, min_margin = LM_CASES[case]
    cfg_j, cfg_t, params_j, params_t = _lm_models(dtype, seed)
    assert params_t["layers"][0]["moe"]["router"].dtype == torch.float32
    assert params_t["layers"][0]["moe"]["experts"]["w_in"].dtype == tlm.dtype_of(cfg_t)
    axes = Axes.from_mesh(mesh11)
    extra = 3
    toks = np.random.default_rng(seed).integers(0, cfg_j.vocab, (b, t + extra), dtype=np.int32)

    margins, real = [], tmoe.moe_apply

    def tap(params, x, cfg, backend, impl="auto"):
        margins.append(float(_margins(params, x, cfg).min()))
        return real(params, x, cfg, backend, impl=impl)
    monkeypatch.setattr(tmoe, "moe_apply", tap)

    prefill_j = jax.jit(lambda p, bt: jlm.prefill(p, cfg_j, bt, cache_len=t + 4, mesh=mesh11,
                                                  axes=axes))
    step_j = jax.jit(lambda p, c, tt: jlm.decode_step(p, cfg_j, c, tt, mesh=mesh11, axes=axes))
    cache_j, logits_j = prefill_j(params_j, {"tokens": jnp.asarray(toks[:, :t])})
    cache_t, logits_t = tlm.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks[:, :t])},
                                    cache_len=t + 4, impl="torch")
    v = cfg_t.vocab
    errs = [_rel_l2(_f32(logits_t)[:, :v], _f32(logits_j)[:, :v])]
    for n in range(extra):
        tt = toks[:, t + n:t + n + 1]
        logits_j, cache_j = step_j(params_j, cache_j, jnp.asarray(tt))
        logits_t, cache_t = tlm.decode_step(params_t, cfg_t, cache_t, torch.from_numpy(tt),
                                            impl="torch")
        errs.append(_rel_l2(_f32(logits_t)[:, :v], _f32(logits_j)[:, :v]))
    assert len(margins) == cfg_t.n_layers * (1 + extra)
    assert min(margins) > min_margin, margins
    assert max(errs) <= tol, errs
    assert cache_t["pos"] == int(cache_j["pos"]) == t + extra


def test_serve_cli_arctic(capsys):
    """``serve.main`` serves the reduced MoE model on the CPU."""
    assert tserve.main(["--arch", ARCH, "--reduced", "--cpu", "--requests", "3",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 9 tokens in ")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_round_trip_and_rank_slices(dtype):
    """The MoE leaves survive JAX -> port -> JAX; each rank's slice holds
    its experts, and the slices in rank order are the whole stack."""
    cfg_j, cfg_t, params_j, params_t = _lm_models(dtype, 3)
    back = interop.lm_params_to_numpy(params_t, cfg_t)
    want = _np_tree(params_j)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape and np.array_equal(np.asarray(a, np.float32), b), path
    nprocs, e = 4, cfg_t.moe.n_experts

    def layout(r, n=nprocs):        # slicing reads the model rank alone
        return Layout(1, n, 0, r, SerialBackend(), SerialBackend())
    for i, bp in enumerate(params_t["layers"]):
        ranks = [shard_params(bp["moe"], cfg_t, layout(r), ("layers", i, "moe"))
                 for r in range(nprocs)]
        for name, full in bp["moe"]["experts"].items():
            parts = [rk["experts"][name] for rk in ranks]
            assert all(p.shape[0] == e // nprocs for p in parts)
            assert torch.equal(torch.cat(parts), full)
        assert all(rk["router"] is bp["moe"]["router"] for rk in ranks)
        for name, full in bp["moe"]["dense"].items():     # tensor-parallel, like the MLP
            dim = 0 if name == "w_out" else 1
            assert torch.equal(torch.cat([rk["dense"][name] for rk in ranks], dim=dim), full)
    with pytest.raises(ValueError, match="does not split over 3 model ranks"):
        shard_params(params_t["layers"][0]["moe"], cfg_t, layout(0, 3))
    with pytest.raises(ValueError, match="holds 2 experts, want 8"):
        tmoe.moe_apply(ranks[1], torch.zeros(1, 2, cfg_t.d_model, dtype=tlm.dtype_of(cfg_t)),
                       cfg_t)


def test_wire_word_slots_past_int32_raise():
    """A send or reply buffer of 2**31 words or more raises before anything
    is allocated, rather than wrapping its int32 word slots."""
    rows = torch.zeros((1, 3), dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    args = (rows, one, one, one, torch.ones(1, dtype=torch.bool), 0, one,
            torch.full((1,), 3, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 3)
    for pack in (binning.pack_rows, lambda *a: kops.pack_rows(*a, impl="torch")):
        with pytest.raises(ValueError, match="exceed int32 slots"):
            pack(*args, 1 << 31)
    assert binning.pack_rows(*args, 3).tolist() == [0, 0, 0]
    # a reply of 7168 lanes over 2**19 slots: 3.8e9 words
    spec = FlowWire(1 << 19, 1, 7170, 7168, 1 << 19, "moe.dispatch")
    staged = {0: torch.zeros((1, 7168), dtype=torch.int32)}
    with pytest.raises(ValueError, match="exceeds int32 slots"):
        DENSE.reply(SerialBackend(), _DenseCtx([spec], "moe.dispatch", "torch"), staged)
    with pytest.raises(ValueError, match="past int32 slots"):
        HierarchicalTransport().reply(SerialBackend(), type("Ctx", (), dict(
            specs=[spec], pr=1, pc=1, c1=[1], c2=[1], plan_op="moe.dispatch"))(), staged)


class _TwoRanks(SerialBackend):
    """Model rank 0 of two: ``all_gather`` stacks this rank's share on the
    other rank's (``other``) and keeps each dtype it is given."""

    def __init__(self, other: torch.Tensor):
        self.other, self.dtypes = other, []

    def nprocs(self):
        return 2

    def all_gather(self, x):
        self.dtypes.append(x.dtype)
        return torch.stack([x, self.other])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,split", [(2, 4, "seq"), (2, 3, "rows")], ids=["seq", "rows"])
def test_moe_gather_carries_outputs_bit_for_bit(monkeypatch, b, t, split, dtype):
    """At two model ranks ``moe_apply`` dispatches this rank's share of the
    tokens (T/P positions of every row, or B*T/P rows of the flattened
    tokens), gathers the ranks' outputs in the model's dtype (bf16 as
    bf16: no int16 words, which gloo refuses) and returns them bit for
    bit, in rank order."""
    cfg = tcfg.reduced(tcfg.get_config(ARCH))
    d, e = cfg.d_model, cfg.moe.n_experts
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, d, generator=g).to(dtype)
    share = (b, t // 2, d) if split == "seq" else (1, b * t // 2, d)
    mine = torch.randn(share, generator=g)                 # float32, as a dispatch returns it
    other = torch.randn(share, generator=g).to(dtype)
    want_x = x[:, :t // 2] if split == "seq" else x.reshape(1, b * t, d)[:, :b * t // 2]

    def dispatch(xl, *args):
        assert torch.equal(xl, want_x)
        return mine, torch.zeros(e), torch.zeros((), dtype=torch.int32), None
    monkeypatch.setattr(tmoe, "_dispatch", dispatch)
    monkeypatch.setattr(tmoe, "_dispatch_dedup", dispatch)
    assert tmoe.token_split(b, t, 2) == split
    bk = _TwoRanks(other)
    params = {"router": torch.randn(d, e, generator=g),
              "experts": {"w_gate": torch.zeros(e // 2, 1, 1)}}
    y, _, _ = tmoe.moe_apply(params, x, cfg, Layout(1, 2, 0, 0, SerialBackend(), bk))
    want = torch.cat([mine.to(dtype), other], dim=1).reshape(b, t, d)
    words = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert y.dtype == dtype and torch.equal(y.view(words), want.view(words))
    assert bk.dtypes == [dtype]
