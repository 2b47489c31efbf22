"""End-to-end training launcher with fault tolerance, the port of
``repro.launch.train`` (the same flags, plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT \
        --save-every 10 --device cpu

Without ``--device`` it runs on the card (and raises where there is none).
  * periodic atomic checkpoints (params, optimizer state; the data cursor
    is the step),
  * ``--resume`` restores bitwise and replays the data stream from there,
  * straggler detection by the ResourceMonitor's step-time EWMA,
  * ``--fail-at N`` simulates a node failure after step N (exit code 42),
  * ``--compress-grads``: bf16 gradients with error feedback.

On the card the step is one CUDA graph (``training.train_step``, the
counterpart of the reference's ``jax.jit``): the first step runs eagerly
and is captured, every later one replays it; ``--resume`` captures over
the restored trees. A capture or replay that fails raises. The run is
deterministic, so a resumed run ends on the same bits as an
uninterrupted one: ``torch.use_deterministic_algorithms(True)`` (for the
run; the caller's setting is restored on return) with
``CUBLAS_WORKSPACE_CONFIG`` set before the first CUDA call.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.monitor import ResourceMonitor
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import elastic_restore
from repro_torch.models import build
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_step import make_train_step


def main(argv=None, on_step: Optional[Callable[[dict], None]] = None
         ) -> int:
    """Runs the CLI; returns its exit code. ``on_step``, where given, is
    called after every step with {"step", "loss", "ce", "moe_aux",
    "moe_z", "grad_norm", "seconds"} (floats but the step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a node failure after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return _run(args, dev, on_step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args, dev, on_step)
    finally:
        torch.use_deterministic_algorithms(was)


def _run(args, dev: torch.device, on_step) -> int:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    ocfg = opt.AdamWConfig(lr=args.lr, compress_grads=args.compress_grads)
    train_step = make_train_step(cfg, ocfg)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    monitor = ResourceMonitor()

    params = model.init_train_params(seed=args.seed, device=dev)
    state = opt.init(params, ocfg)
    start_step = 0

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ckpt and ckpt.latest_step() is not None:
        (params, state), start_step, _ = elastic_restore(
            cfg, ckpt, (params, state), mesh=dev)
        print(f"[train] resumed from step {start_step}")

    loss = math.nan
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = data.batch_at(step)
        params, state, metrics = train_step(params, state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if monitor.observe_step(dt):
            print(f"[train] step {step}: straggler detected "
                  f"({dt:.2f}s vs EWMA "
                  f"{monitor.snapshot().step_time_ewma_s:.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {loss:.4f} grad_norm "
                  f"{float(metrics['grad_norm']):.4f} ({dt:.2f}s)")
        if on_step is not None:
            on_step({"step": step, "seconds": dt,
                     **{k: float(v) for k, v in metrics.items()}})
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, (params, state), extra={"loss": loss})
        if args.fail_at == step:
            print(f"[train] simulated node failure at step {step}",
                  file=sys.stderr)
            return 42
    if ckpt:
        ckpt.save(args.steps, (params, state), extra={"final": True})
    print(f"[train] done: {args.steps} steps, final loss {loss:.4f}, "
          f"stragglers {monitor.stragglers}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
