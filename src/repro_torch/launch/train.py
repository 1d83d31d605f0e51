"""Training driver CLI, as `repro.launch.train`, on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CK --resume \
        --device cpu

Wires together: config -> init/resume -> data pipeline -> train_step ->
ResilientLoop (async checkpoints in the reference's layout, preemption,
retry, straggler watchdog). `--device` defaults to `cuda`, where rwkv6's
recurrence runs the Hopper kernels forward and backward; it needs a card and
fails loudly without one. `--device cpu` runs the plain PyTorch versions.
`--ckpt-dir` defaults to `repro_ckpt` under the temporary directory.
Beside the reference's flags, `--correlation` sets the synthetic token
stream's correlation (default 0.0, the reference CLI's uniform stream, on
which a reduced model's loss starts at ln(vocab) and only drifts).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.ckpt.recovery import LoopConfig, ResilientLoop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_source
from repro_torch.kernels import backend
from repro_torch.launch.specs import ShapeCell
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--correlation", type=float, default=0.0,
                    help="token-stream correlation of the synthetic LM "
                         "source (0: the reference's CLI stream)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the Hopper kernels, needs a card; "
                         "cpu: the plain PyTorch versions")
    return ap


def run(cfg: ModelConfig, args, *, on_metrics=None,
        total_steps: int | None = None) -> dict:
    """Trains `cfg` (already cut as the caller wants) for `args.steps` steps
    under ResilientLoop. Returns {"state", "losses", "start", "seconds",
    "loop"}; `on_metrics(step, metrics)` runs after the CLI's own logging.
    The schedule's length is `total_steps`, by default `args.steps` (the
    CLI's), so that a resumed run can keep the first run's schedule.
    Raises unless the last loss is below the first."""
    device = backend.require_device(args.device)
    cell = ShapeCell("cli", "train", args.seq, args.batch)
    source = make_source(cfg, cell, seed=args.seed,
                         correlation=args.correlation)

    opt = AdamWConfig(lr=args.lr)
    step_fn = make_train_step(
        cfg, opt,
        total_steps=total_steps or args.steps,
        warmup_steps=max(args.steps // 20, 1),
        microbatch=args.microbatch, compress_grads=args.compress_grads,
    )

    def batch_fn(step: int):
        return {k: torch.from_numpy(v).to(device)
                for k, v in source.batch(step).items()}

    loop = ResilientLoop(
        step_fn, batch_fn,
        LoopConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
    )

    def init_fn():
        return init_train_state(cfg, args.seed,
                                compress_grads=args.compress_grads,
                                device=device)

    if args.resume:
        state, start = loop.resume_or_init(init_fn)
    else:
        state, start = init_fn(), 0

    losses = []

    def log(step, m):
        losses.append(float(m["loss"]))
        if step % args.log_every == 0:
            print(
                f"step {step:5d}  loss {float(m['loss']):.4f}  "
                f"gnorm {float(m['grad_norm']):.3f}  lr {float(m['lr']):.2e}",
                flush=True,
            )
        if on_metrics is not None:
            on_metrics(step, m)

    t0 = obs_trace.now()  # perf_counter: monotonic wall-clock discipline
    state = loop.run(state, start, args.steps, on_metrics=log)
    dt = obs_trace.now() - t0
    print(
        f"done: {args.steps} steps in {dt:.1f}s "
        f"({args.steps / max(dt, 1e-9):.2f} it/s); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"stragglers flagged: {len(loop.straggler_events)}"
    )
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"state": state, "losses": losses, "start": start, "seconds": dt,
            "loop": loop}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run(cfg, args)


if __name__ == "__main__":
    main()
