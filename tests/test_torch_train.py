"""The port's training loss and its gradients against the JAX package.

``lm.loss_fn`` and autograd's gradient of every parameter leaf against
``jax.value_and_grad(repro.models.lm.loss_fn)`` (jitted, under a 1 x 1
mesh), with the JAX parameters carried across by
``interop.lm_params_from_numpy`` and the same numpy batch, at ``reduced``
sizes: stablelm-1.6b, qwen3-4b (qk-norm) also with 2 kv heads (GQA),
gemma3-4b (``l`` layers with a 16-key window at T = 64), internvl2-76b
(patch embeddings, their positions dropped before the loss), seamless-m4t-
medium (an encoder over ``src_embeds``), and a dense config with the MTP
head and a random ``loss_mask``.  Float32: the loss at 1e-6 relative, each
gradient leaf at 1e-5 relative L2 (the sums run in another order).  One
bf16 case at 2e-2, the gate ``tests/test_torch_lm.py`` uses for bf16
(XLA's CPU bf16 path rounds at other places).  On the card the attention
backward is the hand-written kernel (``chip_smoke.py``'s training phase);
here ``ops.flash_attention`` runs the plain version under autograd.  Also:
remat on and off give the same gradients in the port, ``remat_policy=
"dots"`` too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro.models.sharding import Axes
from repro_torch import configs as tcfg
from repro_torch import interop, tree
from repro_torch.models import lm as tlm
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LOSS_REL, GRAD_REL = 1e-6, 1e-5
BF16_REL_L2 = 2e-2


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32))
                                  if a.dtype == jnp.bfloat16 else np.asarray(a), t)


def batch_of(cfg, seed: int, b: int = 2, t: int = 24, mask: bool = False) -> dict:
    """A training batch for ``cfg`` from numpy: tokens (B, T+1), a float32
    loss_mask, and the frontend's embeddings."""
    rng = np.random.default_rng(seed)
    n_patch = cfg.frontend_len if cfg.frontend == "patch" else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t - n_patch + 1), dtype=np.int32)}
    out["loss_mask"] = ((rng.random((b, t - n_patch)) < 0.7) if mask
                        else np.ones((b, t - n_patch))).astype(np.float32)
    if n_patch:
        out["patch_embeds"] = rng.standard_normal((b, n_patch, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "frame":
        out["src_embeds"] = rng.standard_normal((b, max(t // 4, 8), cfg.d_model),
                                                dtype=np.float32)
    return out


def jax_loss_and_grads(cfg_j, params_j, batch_np, mesh):
    axes = Axes.from_mesh(mesh)

    def lf(p, b):
        return jlm.loss_fn(p, cfg_j, b, mesh=mesh, axes=axes)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params_j, {k: jnp.asarray(v) for k, v in batch_np.items()})
    return float(loss), metrics, grads


def port_loss_and_grads(cfg_t, params_t, batch_np):
    params_t = tree.map_tree(lambda p: p.detach().requires_grad_(True), params_t)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss, metrics = tlm.loss_fn(params_t, cfg_t, batch)
    leaves = tree.leaves(params_t)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, tree.unflatten(params_t, grads)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def leaf_gaps(got_tree, want_tree) -> dict:
    """Relative L2 gap of each leaf, by path."""
    out = {}

    def walk(g, w, path):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], (*path, k))
        elif isinstance(g, list):
            assert len(g) == len(w), path
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, (*path, i))
        else:
            assert tuple(g.shape) == tuple(w.shape), (path, g.shape, w.shape)
            out["/".join(map(str, path))] = rel_l2(g, w.float())
    walk(got_tree, want_tree, ())
    return out


CASES = {
    "stablelm": ("stablelm-1.6b", {}, {}),
    "qwen3": ("qwen3-4b", {}, {}),
    "qwen3_gqa": ("qwen3-4b", {"n_kv_heads": 2}, {}),
    "gemma3_window": ("gemma3-4b", {}, {"t": 64}),
    "internvl2_patches": ("internvl2-76b", {}, {}),
    "seamless_src": ("seamless-m4t-medium", {}, {}),
    "mtp_masked": ("stablelm-1.6b", {"mtp": True}, {"mask": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(mesh11, name):
    arch, over, bkw = CASES[name]
    cfg_j = jcfg.reduced(jcfg.get_config(arch), **over)
    cfg_t = tcfg.reduced(tcfg.get_config(arch), **over)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(3))
    params_t = interop.lm_params_from_numpy(_np_tree(params_j), cfg_t, "cpu")
    batch = batch_of(cfg_t, 5, **bkw)
    loss_j, met_j, grads_j = jax_loss_and_grads(cfg_j, params_j, batch, mesh11)
    loss_t, met_t, grads_t = port_loss_and_grads(cfg_t, params_t, batch)
    assert abs(float(loss_t) - loss_j) <= LOSS_REL * abs(loss_j), (float(loss_t), loss_j)
    assert abs(float(met_t["nll"]) - float(met_j["nll"])) <= LOSS_REL * abs(float(met_j["nll"]))
    assert float(met_t["aux"]) == float(met_j["aux"]) == 0.0
    want = interop.lm_params_from_numpy(_np_tree(grads_j), cfg_t, "cpu")
    gaps = leaf_gaps(grads_t, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])


def test_bf16_loss_and_grads_match_jax(mesh11):
    cfg_j = jcfg.reduced(jcfg.get_config("stablelm-1.6b"), dtype="bfloat16")
    cfg_t = tcfg.reduced(tcfg.get_config("stablelm-1.6b"), dtype="bfloat16")
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(4))
    params_t = interop.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                            cfg_t, "cpu")
    batch = batch_of(cfg_t, 6)
    loss_j, _, grads_j = jax_loss_and_grads(cfg_j, params_j, batch, mesh11)
    loss_t, _, grads_t = port_loss_and_grads(cfg_t, params_t, batch)
    assert abs(float(loss_t) - loss_j) <= BF16_REL_L2 * abs(loss_j)
    gaps = leaf_gaps(grads_t, interop.lm_params_from_numpy(_np_tree(grads_j), cfg_t, "cpu"))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= BF16_REL_L2, (worst, gaps[worst])


def test_remat_gives_the_same_gradients():
    """remat="block" (and its "dots" policy) recomputes each layer in the
    backward; the gradients are those of remat="none" bit for bit."""
    base = tcfg.reduced(tcfg.get_config("seamless-m4t-medium"))
    params = tlm.init_params(base, torch.Generator().manual_seed(0), "cpu")
    batch = batch_of(base, 9)
    runs = {}
    for remat, policy in (("none", "default"), ("block", "default"), ("block", "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        loss, _, grads = port_loss_and_grads(cfg, params, batch)
        runs[remat, policy] = (loss, tree.leaves(grads))
    ref_loss, ref = runs["none", "default"]
    for key, (loss, grads) in runs.items():
        assert torch.equal(loss, ref_loss), key
        assert all(torch.equal(g, r) for g, r in zip(grads, ref)), key
