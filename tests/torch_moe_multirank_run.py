"""Four-rank MoE dispatch run for tests/test_torch_moe_multirank.py.

    python tests/torch_moe_multirank_run.py jax OUT.npz
        the JAX package's ``moe_apply`` under a (data=1, model=4) mesh of
        4 fake CPU devices (its ``jnp`` path: a Pallas kernel cannot run
        inside shard_map on jax 0.9);
    python tests/torch_moe_multirank_run.py torch OUT_DIR
        the port's ``moe_apply`` on 4 gloo ranks spawned with
        torch.multiprocessing, each holding its experts
        (``interop.moe_params_for_rank``), one rank{r}.npz each.

Both run the same scenarios (reduced arctic-480b, float32) on the same
numpy parameters and inputs: a prefill-shaped call whose T splits over
the 4 ranks (each rank dispatches its slice, the outputs are gathered),
the same with one row per distinct owner, the same split-phase with
retry rounds under a capacity that still drops, and a decode-shaped call
(T = 1: every rank dispatches every token).  Each saves ``y``, ``aux``,
``expert_load``, the wire drops and the cost log as JSON per scenario.
"""

from __future__ import annotations

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

    mesh = make_mesh((1, NPROCS), ("data", "model"))
    axes = Axes.from_mesh(mesh)
    res = {}
    for name in SCENARIOS:
        cfg = config(configs, name)
        p = jax.tree_util.tree_map(jnp.asarray, params_np(cfg))
        with costs.recording() as log:
            y, aux, st = jax.jit(lambda pp, xx, cfg=cfg: moe.moe_apply(pp, xx, cfg, mesh, axes))(
                p, jnp.asarray(x_np(name, cfg.d_model)))
        res.update({f"{name}.y": np.asarray(y), f"{name}.aux": np.asarray(aux),
                    f"{name}.load": np.asarray(st["expert_load"]),
                    f"{name}.dropped": np.asarray(st["dispatch_dropped"]),
                    f"{name}.costs": np.asarray(json.dumps(cost_summary(log)))})
    np.savez(out_path, **res)


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    from repro_torch import configs, interop
    from repro_torch.core import costs
    from repro_torch.core.backend import ProcessGroupBackend
    from repro_torch.models import moe

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=NPROCS, rank=rank)
    try:
        bk = ProcessGroupBackend()
        res = {}
        for name in SCENARIOS:
            cfg = config(configs, name)
            p = interop.moe_params_for_rank(interop.tree_from_numpy(params_np(cfg), "cpu"),
                                            cfg, rank, NPROCS)
            x = torch.from_numpy(x_np(name, cfg.d_model))
            s = moe.router_topk(p, x, cfg)[3].sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            with costs.recording() as log:
                y, aux, st = moe.moe_apply(p, x, cfg, bk, impl="torch")
            res.update({f"{name}.y": y.numpy(), f"{name}.aux": aux.numpy(),
                        f"{name}.load": st["expert_load"].numpy(),
                        f"{name}.dropped": st["dispatch_dropped"].numpy(),
                        f"{name}.margin": (s[..., k - 1] - s[..., k]).min().numpy(),
                        f"{name}.costs": np.asarray(json.dumps(cost_summary(log)))})
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
