"""Training launcher (the reference's `launch/train.py`): data pipeline -> train
step -> checkpointing -> fault tolerance (heartbeats, straggler watch,
failure injection, restore).

    for step in range(start, total):
        batch   <- pipeline.batch(step)                (deterministic resume)
        state   <- step(state, batch)                  (in place)
        monitor <- heartbeats + straggler check        (simulated hosts)
        failure -> save + plan_elastic_mesh + restore  (on the same device)
        every K -> async checkpoint

It runs on the card unless ``--device cpu``.  On one device the elastic
plan is the one-device mesh, so a failure saves and restores onto the same
device, as the reference does on its one-device mesh.  ``--mesh`` (a device
mesh) is accepted by the parser and exits nonzero naming ROADMAP A12.

    python -m repro_torch.launch.train --arch retnet-1.3b --reduced --steps 10 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.hsa import HSAEngine
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import train_step as ts


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default=None, help="single|multi|tiny|tiny_multi")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a simulated host failure at this step")
    ap.add_argument("--n-hosts", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> list[float]:
    """Run the loop; returns the step losses."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh: training on a device mesh is not ported to repro_torch yet "
                 "(ROADMAP A12)")
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    opts = ts.TrainOptions(microbatches=args.microbatches,
                           compress_grads=args.compress_grads)
    device = torch.device(args.device)
    step_fn = ts.train_step_fn(cfg, HSAEngine(), opt_cfg, opts)
    state = ts.init_state(cfg, opt_cfg, opts, seed=0, device=device)
    data = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    mgr = ckpt_lib.CheckpointManager(args.ckpt_dir, keep_n=3)

    start = 0
    if args.resume and mgr.latest_step() is not None:
        _, manifest = mgr.restore(ts.state_tensors(state))
        start = manifest["step"] + 1
        print(f"[train] resumed from step {manifest['step']}")

    hosts = [f"host{i}" for i in range(args.n_hosts)]
    monitor = ft.HeartbeatMonitor(hosts, timeout_s=10.0)
    stragglers = ft.StragglerDetector()
    injector = ft.FailureInjector(
        {args.fail_at: [hosts[-1]]} if args.fail_at >= 0 else {})
    chips, model_parallel = 1, 1          # one device: the one-device mesh

    losses = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.time() - t0
        for h in monitor.alive_hosts():
            monitor.beat(h)
            stragglers.record(h, dt * (1.0 + 0.01 * hash(h) % 3 / 100))

        failed = injector.maybe_fail(step, monitor)
        dead = monitor.check()
        if failed or dead:
            print(f"[train] step {step}: hosts failed: {dead}; checkpoint + elastic re-mesh")
            mgr.save(step, ts.state_tensors(state), extra={"reason": "failure"},
                     blocking=True)
            alive_chips = chips * len(monitor.alive_hosts()) // len(hosts)
            plan = ft.plan_elastic_mesh(max(alive_chips, model_parallel),
                                        model_parallel=model_parallel)
            print(f"[train] elastic plan: {plan}")
            # The plan keeps the one device: the restore lands on it, into the
            # state's own tensors (a second full-width state would not fit).
            mgr.restore(ts.state_tensors(state), step)
            hosts = monitor.alive_hosts()
            monitor = ft.HeartbeatMonitor(hosts, timeout_s=10.0)

        losses.append(loss)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step:4d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        slow = stragglers.stragglers()
        if slow:
            print(f"[train] stragglers detected: {slow}")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            mgr.save(step, ts.state_tensors(state), blocking=False)

    mgr.save(args.steps - 1, ts.state_tensors(state), blocking=True)
    if losses:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"[train] done. loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
