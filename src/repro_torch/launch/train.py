"""Fault-tolerant training entry point (``repro.launch.train`` twin).

Fault-tolerance contract (the paper's preemption semantics):

* checkpoints every --ckpt-every steps (atomic + async, see checkpoint/)
* SIGTERM / SIGINT trigger a final checkpoint and a clean exit 0, so the
  cluster scheduler can preempt at any time
* on start, resumes from the latest checkpoint if one exists; the data
  pipeline is step-addressed, so resume is exactly deterministic
* checkpoints are the JAX package's format: a run of either package
  resumes from the other's

Runs on the GPU unless ``--device cpu`` is given; with no GPU it raises.
The dtype follows the JAX package's rule unless ``--dtype`` is given: f32
on the CPU, bf16 on the card.

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --device cpu --steps 50 --batch 8 --seq 64
On the card, at full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 \\
      --batch 8 --seq 1024 --remat full
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import lm
from repro_torch.optim import init_train_state
from repro_torch.serve import DTYPES
from repro_torch.train import make_train_step
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU smoke) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="default: f32 on the CPU, bf16 on the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype is None:
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    else:
        dtype = DTYPES[args.dtype]
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(args.seed), dtype, device)
    state = init_train_state(params)
    n = sum(x.numel() for x in leaves(params))
    print(f"[train] arch={cfg.name} params={n/1e6:.2f}M backend={device.type}", flush=True)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore(state)
        if restored is not None:
            state = restored
            start_step = int(state["step"])
            print(f"[train] resumed from step {start_step}", flush=True)

    stop = {"now": False}

    def _handle(sig, frame):
        print(f"[train] signal {sig}: checkpoint + clean exit", flush=True)
        stop["now"] = True

    previous = {s: signal.signal(s, _handle) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        data = SyntheticLMDataset(cfg.vocab, args.seq, seed=args.seed)
        step_fn = make_train_step(cfg, lr=args.lr, warmup=10, total=args.steps,
                                  remat=args.remat, ce_chunk=min(512, args.seq))
        losses = []
        t0 = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).long().to(device)
                     for k, v in data.batch(step, args.batch).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0:
                print(f"[train] step {step+1:5d} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                      flush=True)
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
            if stop["now"]:
                if ckpt is not None:
                    ckpt.save(step + 1, state, blocking=True)
                print("[train] exited cleanly after preemption", flush=True)
                return 0
        if ckpt is not None:
            ckpt.save(args.steps, state, blocking=True)
        print(f"[train] done: first-10 avg loss "
              f"{sum(losses[:10])/max(len(losses[:10]),1):.4f}"
              f" -> last-10 avg {sum(losses[-10:])/max(len(losses[-10:]),1):.4f}",
              flush=True)
        return 0
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


if __name__ == "__main__":
    sys.exit(main())
