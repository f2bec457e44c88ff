"""The port's train step and training CLI against the JAX package.

``launch.steps.make_train_step`` from the JAX package's parameters and
AdamW state carried across (``interop.lm_params_from_numpy``,
``interop.opt_state_from_numpy``) against ``jax.jit(make_train_step(cfg,
mesh))`` under a 1 x 1 mesh, for 1 and 3 steps on the same numpy batches
(reduced stablelm-1.6b, float32): the loss, ``grad_norm``, every parameter
and every moment at 1e-5 relative; also with ``grad_accum=2`` (float32
gradients averaged over two microbatches).  What ROADMAP Queue 1 item 7b
brought trains: reduced arctic-480b and deepseek-v3-671b (MoE, MLA, the
MTP head) and ``attn_probs_bf16``, one step of finite loss and gradients
that changes every parameter with a gradient, and one CLI step.  The
refusals: zamba2-7b and rwkv6-1.6b (the recurrent kinds, item 7c) and a
layout of two ranks (item 7d), each naming its ROADMAP item, and the CLI
exiting 2 for the recurrent kinds.  The CLI's kill and restore: ``--kill-at 7`` exits 17,
the rerun prints ``restored checkpoint at step 5``, and its losses at steps
5-11 equal an uninterrupted run's bit for bit (read from the step
function's metrics; the printed lines keep JAX's four decimals).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tcfg
from repro_torch import interop, tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.core.backend import SerialBackend
from repro_torch.models.sharding import Layout
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_train import batch_of, leaf_gaps

REL = 1e-5


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("steps,accum", [(1, 1), (3, 1), (3, 2)])
def test_train_step_matches_jax(mesh11, steps, accum):
    cfg_j = jcfg.reduced(jcfg.get_config("stablelm-1.6b"), grad_accum=accum)
    cfg_t = tcfg.reduced(tcfg.get_config("stablelm-1.6b"), grad_accum=accum)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(1))
    opt_j = jadamw_init(jsteps.opt_config_for(cfg_j), params_j)
    params_t = tsteps.trainable(interop.lm_params_from_numpy(_np(params_j), cfg_t, "cpu"))
    opt_t = interop.opt_state_from_numpy(_np(opt_j), cfg_t, "cpu")
    step_j = jax.jit(jsteps.make_train_step(cfg_j, mesh11))
    step_t = tsteps.make_train_step(cfg_t)
    for s in range(steps):
        batch = batch_of(cfg_t, 20 + s, b=4)
        params_j, opt_j, m_j = step_j(params_j, opt_j, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
        params_t, opt_t, m_t = step_t(params_t, opt_t, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
        for key in ("loss", "nll", "grad_norm"):
            want = float(m_j[key])
            assert abs(float(m_t[key]) - want) <= REL * abs(want), (s, key)
        gaps = leaf_gaps(params_t, interop.lm_params_from_numpy(_np(params_j), cfg_t, "cpu"))
        gaps.update({f"opt/{k}": v for k, v in leaf_gaps(
            opt_t["per_param"],
            interop.opt_state_from_numpy(_np(opt_j), cfg_t, "cpu")["per_param"]).items()})
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= REL, (s, worst, gaps[worst])
        assert int(opt_t["step"]) == int(opt_j["step"]) == s + 1
    back = interop.opt_state_to_numpy(opt_t, cfg_t)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(_np(opt_j))


@pytest.mark.parametrize("arch,over", [
    ("arctic-480b", {}), ("deepseek-v3-671b", {}), ("qwen3-4b", {"attn_probs_bf16": True})],
    ids=["arctic", "deepseek", "probs_bf16"])
def test_item_7b_configs_train(arch, over, capsys):
    cfg = tcfg.reduced(tcfg.get_config(arch), **over)
    params, opt = tsteps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    before = [p.detach().clone() for p in tree.leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 1, t=8).items()}
    grads = torch.autograd.grad(tsteps.lm.loss_fn(params, cfg, batch)[0], tree.leaves(params),
                                allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    params, opt, m = tsteps.make_train_step(cfg)(params, opt, batch)
    assert all(bool(torch.isfinite(m[k])) for k in ("loss", "nll", "aux", "grad_norm"))
    for i, (p, p0, g) in enumerate(zip(tree.leaves(params), before, grads)):
        if g is not None and bool(g.abs().gt(0).any()):
            assert not torch.equal(p.detach(), p0), i
    if not over:
        assert ttrain.main(["--arch", arch, "--reduced", "--cpu", "--steps", "1",
                            "--batch", "2", "--seq", "16"]) == 0
        assert "loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch,layout,item", [
    ("zamba2-7b", None, "7c"), ("rwkv6-1.6b", None, "7c"), ("stablelm-1.6b", (2, 1), "7d")],
    ids=["zamba2", "rwkv6", "two_ranks"])
def test_refusals_name_their_roadmap_item(arch, layout, item, capsys):
    cfg = tcfg.reduced(tcfg.get_config(arch))
    lay = None if layout is None else Layout(*layout, 0, 0, SerialBackend(), SerialBackend())
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tsteps.make_train_step(cfg, layout=lay)
    if layout is None:
        params = tsteps.trainable(tsteps.init_state(cfg, torch.Generator().manual_seed(0),
                                                    "cpu")[0])
        batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 1, t=8).items()}
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tsteps.lm.loss_fn(params, cfg, batch)
        assert ttrain.main(["--arch", arch, "--reduced", "--cpu", "--steps", "1"]) == 2
        assert f"item {item}" in capsys.readouterr().err


def _run(argv, monkeypatch):
    """train.main(argv) with each step's exact loss recorded."""
    losses = []
    real = tsteps.make_train_step

    def recording(cfg):
        step = real(cfg)

        def wrapped(params, opt, batch):
            out = step(params, opt, batch)
            losses.append(float(out[2]["loss"]))
            return out
        return wrapped
    monkeypatch.setattr(ttrain, "make_train_step", recording)
    return ttrain.main(argv), losses


def test_cli_kill_and_restore_bit_for_bit(tmp_path, monkeypatch, capsys):
    args = ["--arch", "stablelm-1.6b", "--reduced", "--cpu", "--steps", "12", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5"]
    rc, _ = _run(args + ck + ["--kill-at", "7"], monkeypatch)
    out = capsys.readouterr().out
    assert rc == 17 and "mesh: {'data': 1, 'model': 1}" in out
    assert "[ft] injected failure at step 7" in out and "resume from step 5" in out
    rc, resumed = _run(args + ck, monkeypatch)
    out = capsys.readouterr().out
    assert rc == 0 and "restored checkpoint at step 5" in out and "(improved)" in out
    assert "step     5 loss" in out and "gnorm" in out and "stragglers=[]" in out
    rc, whole = _run(args, monkeypatch)
    assert rc == 0 and len(whole) == 12 and len(resumed) == 7
    assert resumed == whole[5:]
