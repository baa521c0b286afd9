"""End-to-end fault-tolerant training driver (port of the reference's
launch/train.py, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3-xl \\
        --steps 200 --global-batch 4 --seq 512 \\
        --checkpoint-dir /tmp/ckpt [--resume]

Runs on the GPU unless `--device cpu` is given (`--reduced` configs fit
the CPU).  Wired in as in the reference: the step-indexed resumable data
pipeline (`--data FILE` or seeded synthetic tokens), async checkpoints
every `--checkpoint-every` steps and a blocking one at the end, SIGTERM /
SIGINT -> checkpoint -> exit 42 (`RESTART_EXIT_CODE`), the straggler
watchdog.  `--single-device` is accepted (there is one device); `--compress
int8` is refused: it compresses the cross-pod gradient reduction of a pod
mesh.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import make_stream
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import cosine_schedule
from repro_torch.runtime import PreemptionGuard, StragglerWatchdog
from repro_torch.runtime.fault_tolerance import RESTART_EXIT_CODE


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train a config on one device with checkpoints.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="", help="binary token file (optional)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", default="", choices=["", "int8"])
    ap.add_argument("--single-device", action="store_true",
                    help="accepted: the port trains on one device")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    return ap


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.compress:
        ap.error(f"--compress {args.compress} compresses the cross-pod "
                 f"gradient reduction: it needs a pod mesh, and the port "
                 f"trains on one device")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = steps_mod.make_train_step(
        cfg, lr_fn=cosine_schedule(args.lr, min(100, args.steps // 10 + 1),
                                   args.steps),
        device=args.device)
    dev = bundle.aux["device"]
    stream = make_stream(cfg, global_batch=args.global_batch,
                         seq_len=args.seq + (cfg.n_patches or 0),
                         path=args.data or None, seed=args.seed, device=dev)

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(bundle.aux["state_like"](), device=dev)
        start = int(ckpt.latest_step())
        print(f"resumed from step {start}")
    else:
        state = bundle.aux["init_state"](args.seed)

    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt, mu: print(
            f"[straggler] step {s}: {dt*1e3:.0f}ms vs mean {mu*1e3:.0f}ms"))

    metrics = None
    with PreemptionGuard() as guard:
        for step in range(start, args.steps):
            watchdog.start()
            state, metrics = bundle.fn(state, stream.batch(step))
            _sync(dev)
            watchdog.stop(step)
            if (step + 1) % args.log_every == 0 or step == start:
                print(f"step {step+1:6d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
            if ckpt and (step + 1) % args.checkpoint_every == 0:
                ckpt.save_async(state, step + 1)
            if guard.should_stop:
                print("preempted: checkpointing and exiting for restart")
                if ckpt:
                    ckpt.save(state, step + 1)
                return RESTART_EXIT_CODE
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
    final = "n/a" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"done: {args.steps} steps, final loss {final}, stragglers "
          f"{len(watchdog.events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
