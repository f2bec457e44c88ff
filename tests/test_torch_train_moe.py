"""MoE and MLA training in the port (on the CPU, P=1) against the JAX package.

The JAX package's MoE bitcasts its float wire lanes to u32 words
(``repro/models/moe.py:72-88`` and the dedup weights at ``:271``), and
``jax.grad`` through ``bitcast_convert_type`` is zero: there no expert
weight, and no activation through the wire, gets a gradient.  The port
computes the gradient JAX's docstring defines (``moe.py:25-27``), carried
back over the exchange.  So the results both definitions share are held
against ``repro`` directly, and the rest against ``oracle``: a dense MoE
written here in JAX ops (each token copy through its expert, times its
router weight, where the P=1 dispatch served it: admitted by the wire at
its rank, then held by its expert's bin at its rank there; the bf16
payload rounded per copy on the way out and back, whose cast rounds the
cotangent too, as the port's wire does).  ``jax.grad`` of the oracle is
the reference gradient.

- (a) ``moe_apply`` on every dispatch knob of ``tests/test_torch_moe.py``
  (reduced arctic-480b, float32, the JAX parameters carried across): ``y``
  and ``aux`` against JAX's ``moe_apply`` on a 1 x 1 mesh; the gradients of
  the shared expert and the dense MLP against ``jax.grad`` of it, and the
  router's too where no router weight rides the wire (all but dedup); the
  gradients of x, the router and every expert stack against ``jax.grad`` of
  the oracle, whose ``y`` also equals JAX's.  ``y`` within 1e-5 relative
  L2 (2**-8 of each element on the bf16 payload, as ``test_torch_moe``),
  ``aux`` within 1e-6, gradients within 1e-5 relative L2 (float32 sums in
  another order).  JAX's own expert gradients are asserted exactly zero
  (the caveat, pinned).
- (b) reduced deepseek-v3-671b (MLA, sigmoid routing with ``moe_bias``, the
  shared expert, one dense layer first, the MTP head) and reduced
  arctic-480b (the dense residual MLP): ``lm.loss_fn`` and every leaf's
  gradient against JAX's with ``repro.models.moe.moe_apply`` replaced, in
  this test, by a ``jax.custom_vjp`` whose forward is JAX's own
  ``moe_apply`` and whose backward is the oracle's VJP; one AdamW step
  against JAX's train step the same way (every parameter and moment); the
  step's cost log equal to JAX's trace-time log, entry by entry (JAX scans
  its repeating unit, so one trace logs the MoE layer of every unit where
  the port's layer loop logs each: arctic's two MoE layers log it twice; the
  port's remat recompute and the transposes log nothing).  Loss at 1e-6 relative,
  gradients, parameters and moments at 1e-5 relative L2.
- (c) ``flash_attention_bwd_plain`` with ``probs_bf16`` against ``jax.vjp``
  of ``blockwise_attention(probs_bf16=True)`` on float32 operands, one key
  block (so both round P against the row's max).  JAX's transposes round
  the cotangents of its bf16 operands (dP and dV) to bf16, where the port
  passes them through unchanged: dq and dk at ``PB_JAX_REL_L2``; dV, on dO
  and V exact in bf16, rounded to bf16 at ``PB_JAX_DV_REL_L2``, which the
  backward without the flag breaks tenfold.
- (d) ``train.main --arch deepseek-v3-671b --reduced --cpu`` and arctic-480b:
  the loss falls, and ``--kill-at 7`` restarts bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import costs as jcosts
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.sharding import Axes
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tcfg
from repro_torch import interop, tree
from repro_torch.core import costs as tcosts
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_moe import CASES, _cfgs, _margins, _moe_params
from test_torch_train import _np_tree, batch_of, leaf_gaps, port_loss_and_grads
from test_torch_train_step import _run

Y_REL_L2, AUX_ATOL, GRAD_REL_L2 = 1e-5, 1e-6, 1e-5
LOSS_REL = 1e-6
#: (c): JAX's transposes round the cotangents of its bf16 operands to bf16:
#: dP's (dO / l times round(V)) moves dq and dk by ~2**-9 of each element,
#: 2.7e-3 seen; dV comes out rounded to bf16, held against the port's dV
#: rounded the same way on bf16-exact dO and V, 1.6e-5 seen, and 1.4e-3
#: without the flag
PB_JAX_REL_L2, PB_JAX_DV_REL_L2 = 5e-3, 1e-4
_F32 = jnp.float32


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# the oracle: a dense MoE in JAX ops
# ---------------------------------------------------------------------------

def served_mask(top_idx, cfg, n_tok: int):
    """(n_tok * k,) bool: the copies (token-major) the P=1 dispatch serves,
    by the JAX package's capacities: the wire admits a row whose rank in its
    bucket is below ``capacity x rounds`` (dedup: one row a token, rank t),
    and an expert's bin holds the admitted copies below ``e_cap``, in arrival
    order."""
    mo = cfg.moe
    k, e, slack = mo.top_k, mo.n_experts, cfg.moe_capacity_slack
    rounds = max(1, cfg.moe_dispatch_rounds)
    n = n_tok * k
    if cfg.moe_dedup_dispatch:
        cap = max(1, int(n_tok * min(k, 1.0) / 1 * slack) + 1)
        rank = jnp.arange(n) // k
    else:
        cap = max(1, int(n_tok * k / 1 * slack) + 1)
        rank = jnp.arange(n)
    admitted = rank < cap * max(1, min(rounds, -(-n // cap)))
    e_cap = max(1, int(n_tok * k * 1 / e * slack) + 1) * rounds
    onehot = jax.nn.one_hot(top_idx.reshape(-1), e, dtype=jnp.int32) * admitted[:, None]
    before = jnp.cumsum(onehot, axis=0) - onehot
    brank = jnp.take_along_axis(before, top_idx.reshape(-1, 1), axis=1)[:, 0]
    return admitted & (brank < e_cap)


def oracle(params, x, cfg):
    """(y, aux) of the MoE layer on x (B, T, D), densely."""
    mo = cfg.moe
    k, e = mo.top_k, mo.n_experts
    b, t, d = x.shape
    xf = x.reshape(b * t, d).astype(_F32)
    gate = xf @ params["router"]
    if "moe_bias" in params:
        _, idx = jax.lax.top_k(jax.nn.sigmoid(gate) + params["moe_bias"], k)
        top_p = jnp.take_along_axis(jax.nn.sigmoid(gate), idx, axis=-1)
    else:
        top_p, idx = jax.lax.top_k(jax.nn.softmax(gate, axis=-1), k)
    w = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    probs_mean = jax.nn.softmax(gate, -1).mean(axis=0)
    hard = jnp.zeros((e,), _F32).at[idx.reshape(-1)].add(1.0)
    aux = mo.aux_loss_coef * e * jnp.sum(probs_mean * hard / jnp.maximum(hard.sum(), 1.0))

    bf16 = cfg.moe_payload_dtype == "bfloat16"

    def wire(a):                       # what the payload dtype keeps (and its cotangent)
        return a.astype(jnp.bfloat16).astype(_F32) if bf16 else a
    ids = idx.reshape(-1)
    ex = params["experts"]
    xr = wire(jnp.repeat(xf, k, axis=0)).astype(ex["w_gate"].dtype)
    if cfg.activation in ("swiglu", "geglu"):
        act = jax.nn.silu if cfg.activation == "swiglu" else jax.nn.gelu
        h = act(jnp.einsum("nd,ndf->nf", xr, ex["w_gate"][ids])) * \
            jnp.einsum("nd,ndf->nf", xr, ex["w_in"][ids])
    else:
        h = jlayers.activation_fn(cfg.activation)(jnp.einsum("nd,ndf->nf", xr, ex["w_in"][ids]))
    yc = jnp.einsum("nf,nfd->nd", h, ex["w_out"][ids]).astype(_F32)
    keep = served_mask(idx, cfg, b * t).reshape(b * t, k, 1)
    yc = yc.reshape(b * t, k, d)
    wk = w[..., None]
    if cfg.moe_dedup_dispatch:         # the owner sums its experts' weighted outputs
        y = wire(jnp.sum(jnp.where(keep, yc * wk, 0.0), axis=1))
    else:
        y = jnp.sum(jnp.where(keep, wire(yc), 0.0) * wk, axis=1)
    y = y.reshape(b, t, d).astype(x.dtype)
    for name in ("shared", "dense"):
        if name in params:
            y = y + jlayers.mlp(params[name], x, cfg.activation)
    return y, aux


def _oracle_moe_apply(real):
    """``repro.models.moe.moe_apply`` with the oracle's VJP: forward JAX's
    own, backward the gradient the oracle defines."""
    def moe_apply(params, x, cfg, mesh, axes):
        @jax.custom_vjp
        def f(p, xx):
            return real(p, xx, cfg, mesh, axes)

        def fwd(p, xx):
            with jcosts.recording():   # f's trace logs the layer, as the real step's does
                out = real(p, xx, cfg, mesh, axes)
            return out, (p, xx)

        def bwd(res, ct):
            _, vjp = jax.vjp(lambda p, xx: oracle(p, xx, cfg), *res)
            return vjp((ct[0], ct[1]))
        f.defvjp(fwd, bwd)
        return f(params, x)
    return moe_apply


# ---------------------------------------------------------------------------
# (a) moe_apply
# ---------------------------------------------------------------------------

GRAD_KEYS = ("router", "experts", "shared", "dense")


def _port_grads(pt, x, cfg, g_y: np.ndarray, g_aux: float):
    """y, aux and the gradients of sum(y * g_y) + g_aux * aux in the port."""
    leaves = tree.leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with tcosts.recording() as log:
        y, aux, _ = tmoe.moe_apply(pt, xt, cfg, impl="torch")
        loss = (y * torch.from_numpy(g_y)).sum() + g_aux * aux
    gx, *gp = torch.autograd.grad(loss, [xt] + leaves, allow_unused=True)
    gp = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gp)]
    return y.detach().numpy(), float(aux.detach()), gx.numpy(), \
        _np_tree(tree.map_tree(lambda g: g.numpy(), tree.unflatten(pt, gp))), log


def _jax_grads(fn, pj, x, g_y, g_aux):
    def loss(p, xx):
        y, aux = fn(p, xx)[:2]
        return jnp.sum(y * g_y) + g_aux * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        pj, jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(gx), _np_tree(gp)


def _leaf_rel(got: dict, want: dict, key: str) -> float:
    g, w = jax.tree_util.tree_leaves(got[key]), jax.tree_util.tree_leaves(want[key])
    return max(_rel_l2(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("case", CASES)
def test_moe_gradients(mesh11, case):
    cfg_j, cfg_t = _cfgs(**CASES[case])
    pj, pt = _moe_params(cfg_j, cfg_t, seed=0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, cfg_j.d_model)).astype(np.float32)
    g_y = rng.normal(size=x.shape).astype(np.float32)
    g_aux = 3.0
    assert float(_margins(pt, torch.from_numpy(x), cfg_t).min()) > 1e-6

    axes = Axes.from_mesh(mesh11)
    yj, auxj, gxj, gpj = _jax_grads(lambda p, xx: jmoe.moe_apply(p, xx, cfg_j, mesh11, axes),
                                    pj, x, g_y, g_aux)
    yo, auxo, gxo, gpo = _jax_grads(lambda p, xx: oracle(p, xx, cfg_j), pj, x, g_y, g_aux)
    yt, auxt, gxt, gpt, _ = _port_grads(pt, x, cfg_t, g_y, g_aux)

    # the caveat: JAX's expert gradients are zero, the oracle's are not
    assert all(not np.any(a) for a in jax.tree_util.tree_leaves(gpj["experts"]))
    assert all(np.any(a) for a in jax.tree_util.tree_leaves(gpo["experts"]))

    bf16 = cfg_t.moe_payload_dtype == "bfloat16"
    for y in (yt, yo):
        if bf16:
            np.testing.assert_allclose(y, yj, rtol=2.0 ** -8, atol=1e-6)
        else:
            assert _rel_l2(y, yj) <= Y_REL_L2
    assert abs(auxt - auxj) <= AUX_ATOL and abs(auxo - auxj) <= AUX_ATOL
    # what both definitions share, against JAX itself
    shared = [kk for kk in ("shared", "dense") if kk in gpt]
    if not cfg_t.moe_dedup_dispatch:   # dedup's router weights ride the wire
        shared.append("router")
    for key in shared:
        assert _leaf_rel(gpt, gpj, key) <= GRAD_REL_L2, (case, key)
    # the rest against the oracle
    assert _rel_l2(gxt, gxo) <= GRAD_REL_L2, case
    for key in [kk for kk in GRAD_KEYS if kk in gpt]:
        assert _leaf_rel(gpt, gpo, key) <= GRAD_REL_L2, (case, key)
    if "moe_bias" in gpt:              # top_k gives the bias no gradient
        assert not np.any(gpt["moe_bias"])


# ---------------------------------------------------------------------------
# (b) the LM: loss, gradients, one AdamW step, the cost log
# ---------------------------------------------------------------------------

LM_ARCHS = ("deepseek-v3-671b", "arctic-480b")


def _lm_models(arch: str, seed: int = 1):
    """The reduced float32 model in both packages: the port's seeded draw,
    carried into JAX's layout."""
    cfg_j = jcfg.reduced(jcfg.get_config(arch))
    cfg_t = tcfg.reduced(tcfg.get_config(arch))
    drawn = interop.lm_params_to_numpy(
        tlm.init_params(cfg_t, torch.Generator().manual_seed(seed), "cpu"), cfg_t)
    params_j = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype), drawn,
                                      jlm.abstract_params(cfg_j))
    return cfg_j, cfg_t, params_j


def _entries(log) -> list:
    return [(name, cost.__dict__) for name, cost in log.entries]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_training_matches_jax(mesh11, monkeypatch, arch):
    cfg_j, cfg_t, params_j = _lm_models(arch)
    monkeypatch.setattr(jmoe, "moe_apply", _oracle_moe_apply(jmoe.moe_apply))
    batch = batch_of(cfg_t, 5, b=2, t=12)
    axes = Axes.from_mesh(mesh11)

    def lf(p, b):
        return jlm.loss_fn(p, cfg_j, b, mesh=mesh11, axes=axes)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params_t = interop.lm_params_from_numpy(_np_tree(params_j), cfg_t, "cpu")
    loss_t, _, grads_t = port_loss_and_grads(cfg_t, params_t, batch)
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    gaps = leaf_gaps(grads_t, interop.lm_params_from_numpy(_np_tree(grads_j), cfg_t, "cpu"))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_REL_L2, (worst, gaps[worst])

    # one AdamW step, and its cost log against JAX's trace-time log
    opt_j = jadamw_init(jsteps.opt_config_for(cfg_j), params_j)
    params_t = tsteps.trainable(interop.lm_params_from_numpy(_np_tree(params_j), cfg_t, "cpu"))
    opt_t = interop.opt_state_from_numpy(_np_tree(opt_j), cfg_t, "cpu")
    with jcosts.recording() as log_j:
        params_j, opt_j, m_j = jax.jit(jsteps.make_train_step(cfg_j, mesh11))(
            params_j, opt_j, {k: jnp.asarray(v) for k, v in batch.items()})
    with tcosts.recording() as log_t:
        params_t, opt_t, m_t = tsteps.make_train_step(cfg_t)(
            params_t, opt_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    # JAX scans its repeating unit: one trace logs one MoE layer for the stack
    n_moe = sum("moe" in lp for lp in params_t["layers"])
    n_traced = sum(name == "exchange.bin" for name, _ in log_j.entries)
    assert n_traced and n_moe % n_traced == 0
    assert _entries(log_t) == _entries(log_j) * (n_moe // n_traced)
    for key in ("loss", "nll", "aux", "grad_norm"):
        want = float(m_j[key])
        assert abs(float(m_t[key]) - want) <= GRAD_REL_L2 * max(abs(want), 1e-6), key
    gaps = leaf_gaps(params_t, interop.lm_params_from_numpy(_np_tree(params_j), cfg_t, "cpu"))
    gaps.update({f"opt/{k}": v for k, v in leaf_gaps(
        opt_t["per_param"],
        interop.opt_state_from_numpy(_np_tree(opt_j), cfg_t, "cpu")["per_param"]).items()})
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_REL_L2, (worst, gaps[worst])


# ---------------------------------------------------------------------------
# (c) the probs_bf16 backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,t,d", [(1, 4, 2, 40, 16), (2, 2, 2, 33, 24)],
                         ids=["gqa", "mla_like"])
def test_probs_bf16_backward_vs_jax(b, hq, hkv, t, d):
    """dq, dk within PB_JAX_REL_L2; dV, on dO and V of a few bits (exact in
    bf16), rounded to bf16 as JAX's comes out, within PB_JAX_DV_REL_L2, which
    the backward without the flag breaks."""
    rng = np.random.default_rng(t)
    q, k = (rng.standard_normal(s, dtype=np.float32) for s in ((b, hq, t, d), (b, hkv, t, d)))
    v, do = ((rng.integers(-4, 5, s) / 4).astype(np.float32) for s in ((b, hkv, t, d),
                                                                         (b, hq, t, d)))

    def f(q_, k_, v_):
        return jattn.blockwise_attention(q_, k_, v_, causal=True, probs_bf16=True)
    want = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]))(*map(jnp.asarray, (q, k, v, do)))
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    runs = {pb: tfa.flash_attention_bwd_plain(*ts, causal=True, probs_bf16=pb)
            for pb in (True, False)}
    got = runs[True]
    gaps = {n: _rel_l2(g.numpy(), w) for n, g, w in zip(("dq", "dk"), got, want)}
    assert max(gaps.values()) <= PB_JAX_REL_L2, gaps

    def dv_gap(dv):
        return _rel_l2(dv.to(torch.bfloat16).float().numpy(), want[2])
    assert dv_gap(got[2]) <= PB_JAX_DV_REL_L2 < dv_gap(runs[False][2]) / 10


# ---------------------------------------------------------------------------
# (d) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cli_trains_and_restarts_bit_for_bit(tmp_path, monkeypatch, capsys, arch):
    args = ["--arch", arch, "--reduced", "--cpu", "--steps", "12", "--batch", "4", "--seq",
            "32", "--log-every", "1"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5"]
    rc, whole = _run(args, monkeypatch)
    assert rc == 0 and "(improved)" in capsys.readouterr().out
    assert np.mean(whole[-3:]) < np.mean(whole[:3])
    rc, _ = _run(args + ck + ["--kill-at", "7"], monkeypatch)
    assert rc == 17
    rc, resumed = _run(args + ck, monkeypatch)
    assert rc == 0 and "restored checkpoint at step 5" in capsys.readouterr().out
    assert resumed == whole[5:]
