"""Four-rank MoE dispatch and multi-rank LM runs for tests/test_torch_moe_multirank.py.

    python tests/torch_moe_multirank_run.py jax OUT.npz
        the JAX package's ``moe_apply`` under a (data=1, model=4) mesh of
        4 fake CPU devices (its ``jnp`` path: a Pallas kernel cannot run
        inside shard_map on jax 0.9), and its LM's ``prefill`` and
        ``decode_step`` under (1, 4) and (2, 2) meshes;
    python tests/torch_moe_multirank_run.py torch OUT_DIR
        the port's on 4 gloo ranks spawned with torch.multiprocessing,
        each holding its slice of the parameters (``sharding.shard_params``,
        or ``lm.init_params`` with the rank's layout), one rank{r}.npz each.

Both run the same MoE scenarios (reduced arctic-480b, float32) on the same
numpy parameters and inputs: a prefill-shaped call whose T splits over
the 4 ranks (each rank dispatches its slice, the outputs are gathered),
the same with one row per distinct owner, the same split-phase with
retry rounds under a capacity that still drops, and a decode-shaped call
(T = 1, B = 4: each rank dispatches one row of the flattened tokens; the
JAX side runs it as ``x.reshape(1, B*T, D)``, whose sequence splits).
Each saves ``y``, ``aux``, ``expert_load``, the wire drops and the cost
log as JSON per scenario.

The LM scenarios (float32, ``moe_capacity_slack`` 8.0, 4 prompts of 8
tokens, internvl2-76b's after 8 patch embeddings, seamless-m4t-medium's
beside 12 source frames, 3 decode steps of fixed tokens; zamba2-7b's
Mamba2 at 8 heads, 2 a rank) start from the port's seeded
one-rank draw: the JAX side carries it across (``lm_params_to_numpy``),
each gloo rank draws its own slice (``lm.init_params(..., layout)``), or
at (2, 2) slices the carried tree (``interop.lm_params_for_rank``).
Each saves the logits of the prefill and of every decode step (a rank
its data rank's rows), the router margin, and ``serve``'s tokens at the
layout and, on rank 0, at one rank.  JAX's prefill of an encoder-decoder
writes no ``xk``/``xv`` (ROADMAP Queue 3, records), so its side fills them
from ``lm.encode`` under the same mesh before decoding, as
``tests/test_torch_encdec.py`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

NPROCS = 4
RANKS_TIMEOUT_S = 100
ARCH = "arctic-480b"

#: name -> (ArchConfig overrides, batch, tokens)
SCENARIOS = {
    "seq": ({}, 2, 8),
    "seq_dedup": (dict(moe_dedup_dispatch=True), 2, 8),
    "seq_async_rounds": (dict(moe_async_dispatch=True, moe_dispatch_rounds=2,
                              moe_capacity_slack=0.3), 2, 8),
    "decode": ({}, 4, 1),
}

#: name -> (arch, ArchConfig overrides, (data, model)); float32 at slack 8.0
LM_SCENARIOS = {
    "lm_qwen3": ("qwen3-4b", {}, (1, 4)),
    "lm_qwen3_kv2": ("qwen3-4b", dict(n_kv_heads=2), (1, 4)),
    "lm_arctic": ("arctic-480b", {}, (1, 4)),
    "lm_arctic_2x2": ("arctic-480b", {}, (2, 2)),
    "lm_deepseek_cp": ("deepseek-v3-671b", dict(mla_absorb=True, mla_cp_decode=True), (1, 4)),
    "lm_internvl": ("internvl2-76b", {}, (1, 4)),     # the patch frontend's embeddings
    "lm_zamba2": ("zamba2-7b", dict(ssm_n_heads=8), (1, 4)),  # m and the shared a block
    "lm_rwkv6": ("rwkv6-1.6b", {}, (1, 4)),
    "lm_seamless": ("seamless-m4t-medium", {}, (1, 4)),  # the encoder, frames, cross K/V
}
LM_BATCH, LM_PROMPT, LM_STEPS, LM_SEED, LM_SRC = 4, 8, 3, 3, 12
SERVE_REQUESTS, SERVE_GEN = 6, 4


def lm_cache(cfg) -> int:
    """The patches, the prompt and the decode steps, and one more: a multiple
    of 4 ranks (the MLA cache's sequence splits over them; serve's too)."""
    return (cfg.frontend_len if cfg.frontend == "patch" else 0) + LM_PROMPT + LM_STEPS + 1


def lm_config(pkg, name: str):
    """The scenario's reduced config; ``ssm_n_heads`` sets Mamba2's heads
    in the package's own ``SSMConfig``."""
    arch, over, _ = LM_SCENARIOS[name]
    cfg = pkg.reduced(pkg.get_config(arch), moe_capacity_slack=8.0)
    over = dict(over)
    if "ssm_n_heads" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, n_heads=over.pop("ssm_n_heads"))
    return dataclasses.replace(cfg, **over)


def lm_tokens(cfg) -> tuple[dict, np.ndarray, dict]:
    """The prefill batch (B, T) with a ``patch`` model's embeddings (B, P,
    D) or a ``frame`` model's source (B, LM_SRC, D), the decode steps'
    tokens (B, steps) and serve's prompts (R, T) and embeddings."""
    rng = np.random.default_rng(11)
    n = (LM_BATCH, SERVE_REQUESTS)
    batch, reqs = ({"tokens": rng.integers(0, cfg.vocab, (b, LM_PROMPT), dtype=np.int32)}
                   for b in n)
    steps = rng.integers(0, cfg.vocab, (LM_BATCH, LM_STEPS), dtype=np.int32)
    if cfg.frontend:
        key, n_pos = (("patch_embeds", cfg.frontend_len) if cfg.frontend == "patch"
                      else ("src_embeds", LM_SRC))
        for b, d in zip(n, (batch, reqs)):
            d[key] = rng.normal(size=(b, n_pos, cfg.d_model)).astype(np.float32)
    return batch, steps, reqs


def cross_filled(lm, params, cfg, cache, src, mesh, axes):
    """JAX's prefill cache with each decoder layer's ``xk``/``xv`` (B, Hkv,
    S, hd) filled as its decode branch reads them: ``lm.encode``'s output
    under the mesh through the layer's ``xattn.wk``/``wv`` (every layer
    of a reduced encoder-decoder is in the scanned ``stack``)."""
    import jax
    import jax.numpy as jnp
    enc = jax.jit(lambda pp, ss: lm.encode(pp, cfg, ss, mesh, axes))(params, src)
    b, s = enc.shape[:2]
    xattn = params["stack"]["p0"]["xattn"]

    def proj(w):     # w (units, D, Hkv*hd) -> (units, B, Hkv, S, hd)
        y = jnp.einsum("bsd,ude->ubse", enc, w)
        return y.reshape(w.shape[0], b, s, cfg.n_kv_heads, cfg.head_dim).transpose(
            0, 1, 3, 2, 4)
    stack = dict(cache["stack"])
    stack["p0"] = dict(stack["p0"], xk=proj(xattn["wk"]), xv=proj(xattn["wv"]))
    return dict(cache, stack=stack)


def lm_generator():
    import torch
    return torch.Generator().manual_seed(LM_SEED)


def config(pkg, name: str):
    over, _, _ = SCENARIOS[name]
    return pkg.reduced(pkg.get_config(ARCH), **over)


def params_np(cfg) -> dict:
    """``moe_init``'s tree (router, experts, the dense residual MLP) drawn
    with numpy at its scales."""
    rng = np.random.default_rng(7)
    d, f, e, ff = cfg.d_model, cfg.moe.expert_d_ff, cfg.moe.n_experts, cfg.d_ff

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"router": normal((d, e), d ** -0.5),
            "experts": {"w_gate": normal((e, d, f), d ** -0.5),
                        "w_in": normal((e, d, f), d ** -0.5),
                        "w_out": normal((e, f, d), f ** -0.5)},
            "dense": {"w_in": normal((d, ff), d ** -0.5), "w_out": normal((ff, d), ff ** -0.5),
                      "w_gate": normal((d, ff), d ** -0.5)}}


def x_np(name: str, d: int) -> np.ndarray:
    _, b, t = SCENARIOS[name]
    return np.random.default_rng(len(name)).normal(size=(b, t, d)).astype(np.float32)


def cost_summary(log) -> dict:
    return {name: log.by_op(name).__dict__ for name in sorted({n for n, _ in log.entries})}


def run_jax(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={NPROCS}"
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.compat import make_mesh
    from repro.core import costs
    from repro.models import moe
    from repro.models.sharding import Axes

    from repro.models import lm
    from repro_torch import configs as tconfigs
    from repro_torch import interop
    from repro_torch.models import lm as tlm

    mesh = make_mesh((1, NPROCS), ("data", "model"))
    axes = Axes.from_mesh(mesh)
    res = {}
    for name in SCENARIOS:
        cfg = config(configs, name)
        p = jax.tree_util.tree_map(jnp.asarray, params_np(cfg))
        x = x_np(name, cfg.d_model)
        b, t, d = x.shape
        with costs.recording() as log:
            # T % P != 0: the port dispatches each row of the flattened tokens once,
            # as JAX's split of x.reshape(1, B*T, D) does
            y, aux, st = jax.jit(lambda pp, xx, cfg=cfg: moe.moe_apply(pp, xx, cfg, mesh, axes))(
                p, jnp.asarray(x if t % NPROCS == 0 else x.reshape(1, b * t, d)))
        y = np.asarray(y).reshape(b, t, d)
        res.update({f"{name}.y": y, f"{name}.aux": np.asarray(aux),
                    f"{name}.load": np.asarray(st["expert_load"]),
                    f"{name}.dropped": np.asarray(st["dispatch_dropped"]),
                    f"{name}.costs": np.asarray(json.dumps(cost_summary(log)))})
    for name, (_, _, shape) in LM_SCENARIOS.items():
        cfg, tcfg = lm_config(configs, name), lm_config(tconfigs, name)
        whole = interop.lm_params_to_numpy(tlm.init_params(tcfg, lm_generator(), "cpu"), tcfg)
        p = jax.tree_util.tree_map(jnp.asarray, whole)
        lm_mesh = make_mesh(shape, ("data", "model"))
        lm_axes = Axes.from_mesh(lm_mesh)
        batch, steps, _ = lm_tokens(cfg)
        cache, logits = jax.jit(lambda pp, bb, cfg=cfg: lm.prefill(
            pp, cfg, bb, lm_cache(cfg), mesh=lm_mesh, axes=lm_axes))(p, batch)
        res[f"{name}.logits0"] = np.asarray(logits)
        if cfg.encoder_layers:
            cache = cross_filled(lm, p, cfg, cache, batch["src_embeds"], lm_mesh, lm_axes)
        step = jax.jit(lambda pp, cc, tt, cfg=cfg: lm.decode_step(pp, cfg, cc, tt, mesh=lm_mesh,
                                                                  axes=lm_axes))
        for s in range(LM_STEPS):
            logits, cache = step(p, cache, steps[:, s:s + 1])
            res[f"{name}.logits{s + 1}"] = np.asarray(logits)
    np.savez(out_path, **res)


def _lm_rank(name: str, rank: int, res: dict) -> None:
    """One LM scenario on this gloo rank: prefill and decode steps against
    the JAX logits of its data rank's rows, then ``serve`` at the layout
    (and at one rank, on rank 0)."""
    import torch

    from repro_torch import configs, interop
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, moe
    from repro_torch.models.sharding import Layout

    cfg = lm_config(configs, name)
    lay = Layout.over(*LM_SCENARIOS[name][2])
    if lay.data > 1:    # the JAX tree carried across and sliced, as a loaded model is
        whole = interop.lm_params_to_numpy(lm.init_params(cfg, lm_generator(), "cpu"), cfg)
        params = interop.lm_params_for_rank(whole, cfg, lay, "cpu")
    else:               # each rank draws its own slice
        params = lm.init_params(cfg, lm_generator(), "cpu", lay)
    batch, steps, reqs = lm_tokens(cfg)
    steps = torch.from_numpy(steps)
    batch, reqs = ({k: torch.from_numpy(a) for k, a in d.items()} for d in (batch, reqs))
    nb = LM_BATCH // lay.data
    rows = slice(lay.data_rank * nb, (lay.data_rank + 1) * nb)
    k = cfg.moe.top_k if cfg.moe else 0
    margins, real = [], moe.router_topk

    def tap(p, x, c):
        out = real(p, x, c)
        sc = out[3].sort(dim=-1, descending=True).values
        margins.append(float((sc[..., k - 1] - sc[..., k]).min()))
        return out
    moe.router_topk = tap
    try:
        cache, logits = lm.prefill(params, cfg, {k: a[rows] for k, a in batch.items()},
                                   lm_cache(cfg), impl="torch", layout=lay)
        res[f"{name}.logits0"] = logits.numpy()
        for s in range(LM_STEPS):
            logits, cache = lm.decode_step(params, cfg, cache, steps[rows, s:s + 1],
                                           impl="torch", layout=lay)
            res[f"{name}.logits{s + 1}"] = logits.numpy()
    finally:
        moe.router_topk = real
    res[f"{name}.margin"] = np.asarray(min(margins) if margins else 1.0)
    prompts = reqs.pop("tokens")
    out = serve(params, cfg, prompts, LM_BATCH, SERVE_GEN, "torch", layout=lay, **reqs)
    res[f"{name}.serve"] = np.asarray([out[i] for i in range(SERVE_REQUESTS)])
    if rank == 0:
        one = serve(lm.init_params(cfg, lm_generator(), "cpu"), cfg, prompts, LM_BATCH,
                    SERVE_GEN, "torch", **reqs)
        res[f"{name}.serve_one_rank"] = np.asarray([one[i] for i in range(SERVE_REQUESTS)])


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    from repro_torch import configs, interop
    from repro_torch.core import costs
    from repro_torch.models import moe
    from repro_torch.models.sharding import Layout, shard_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=NPROCS, rank=rank)
    try:
        lay = Layout.over(1, NPROCS)
        res = {}
        for name in SCENARIOS:
            cfg = config(configs, name)
            p = shard_params(interop.tree_from_numpy(params_np(cfg), "cpu"), cfg, lay,
                             ("layers", 0, "moe"))
            x = torch.from_numpy(x_np(name, cfg.d_model))
            s = moe.router_topk(p, x, cfg)[3].sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            with costs.recording() as log:
                y, aux, st = moe.moe_apply(p, x, cfg, lay, impl="torch")
            res.update({f"{name}.y": y.numpy(), f"{name}.aux": aux.numpy(),
                        f"{name}.load": st["expert_load"].numpy(),
                        f"{name}.dropped": st["dispatch_dropped"].numpy(),
                        f"{name}.margin": (s[..., k - 1] - s[..., k]).min().numpy(),
                        f"{name}.costs": np.asarray(json.dumps(cost_summary(log)))})
        for name in LM_SCENARIOS:
            _lm_rank(name, rank, res)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_torch(out_dir: str) -> None:
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_rank, args=(port, out_dir), nprocs=NPROCS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after {RANKS_TIMEOUT_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


if __name__ == "__main__":
    mode, target = sys.argv[1], sys.argv[2]
    run_jax(target) if mode == "jax" else run_torch(target)
