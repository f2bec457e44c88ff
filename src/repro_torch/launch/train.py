"""End-to-end training driver (the port of ``repro/launch/train.py``).

Wires the stack on one rank: config -> init -> train step -> the
deterministic data stream -> the checkpoint manager (async, atomic,
retained) -> the fault-tolerance hooks (heartbeats and the straggler
EWMA; on one process the heartbeat source is simulated, the decision
logic is the production state machine).  It runs on the card unless
``--cpu`` is given, and without a card it exits non-zero.  The JAX
package's flags and printed lines, plus ``--cpu``.  It trains the dense,
MoE and MLA architectures (deepseek-v3-671b with its MTP head, arctic-480b);
one the port cannot train yet (the recurrent kinds) exits 2 naming the
ROADMAP item that brings it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --cpu --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck

``--kill-at N`` injects a failure at step N (exit 17); rerunning the same
command restores the newest checkpoint and continues to the target step
with the same data order and, on the same device, the same losses bit for
bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.steps import init_state, make_train_step, trainable
from repro_torch.models import lm
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.ft import FaultToleranceManager, StragglerDetector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--async-dispatch", action="store_true",
                    help="split-phase MoE dispatch")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("train: no CUDA device (pass --cpu to train on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.async_dispatch:
        cfg = dataclasses.replace(cfg, moe_async_dispatch=True)
    try:
        lm.check_trainable(cfg)
    except NotImplementedError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2

    n_dev = 1
    shape = {"data": 1, "model": 1}
    print(f"mesh: {shape}")

    params, opt = init_state(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    step_fn = make_train_step(cfg)

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every) \
        if args.ckpt_dir else None
    ft = FaultToleranceManager(n_nodes=n_dev)
    strag = StragglerDetector(n_nodes=n_dev)

    start_step = 0
    if ckpt and latest_step(args.ckpt_dir) is not None:
        (params, opt, stream_state), start_step = ckpt.restore_latest(
            (params, opt, stream.state_dict()))
        trainable(params)
        stream.load_state_dict({k: int(v) for k, v in stream_state.items()})
        print(f"restored checkpoint at step {start_step}")

    stream.step = start_step
    losses = []
    for step in range(start_step, args.steps):
        if args.kill_at is not None and step == args.kill_at:
            if ckpt:
                ckpt.wait()   # drain the in-flight async save, as a preemption handler would
            # drive the recovery state machine with the kill: node 0 goes
            # silent, every survivor keeps heartbeating, and the detector's
            # decision selects the restart step + remesh
            killed = 0
            now = time.time()
            for node in range(n_dev):
                if node != killed:
                    ft.heartbeat(node, now)
            ckpt_step = (latest_step(args.ckpt_dir) or 0) if ckpt else 0
            dec = ft.tick(now + ft.interval * ft.timeout_beats, last_ckpt_step=ckpt_step)
            print(f"[ft] injected failure at step {step}: "
                  f"node {killed} silent -> decision {dec}")
            if dec.failed_nodes and not dec.promoted_spares:
                survivors = n_dev - len(dec.failed_nodes)
                try:
                    plan = plan_remesh(tuple(shape), tuple(shape.values()), survivors)
                    print(f"[ft] remesh plan: {plan.old_shape} -> {plan.new_shape} (dropped "
                          f"{plan.dropped_devices}, batch/shard x"
                          f"{plan.batch_per_shard_scale:.2f})")
                except ValueError as e:
                    print(f"[ft] remesh impossible: {e}")
            print(f"[ft] restart this command to resume from step "
                  f"{dec.restart_step}; the survivors re-inject the dead "
                  "rank's checkpointed container shards on restore")
            return 17
        hb = time.time()
        batch = stream.next_batch(device=dev)
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        for node in range(n_dev):
            ft.heartbeat(node, hb)
            strag.observe(node, dt)
        dec = ft.tick(time.time(), last_ckpt_step=step)
        if dec.action != "none":
            print(f"[ft] decision: {dec}")
        if ckpt:
            ckpt.maybe_save(step + 1, (params, opt, stream.state_dict()))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{dt*1000:7.1f} ms "
                  f"stragglers={strag.stragglers()}")
        if not np.isfinite(loss):
            print("NON-FINITE LOSS — aborting")
            return 1
    if ckpt:
        ckpt.wait()
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
