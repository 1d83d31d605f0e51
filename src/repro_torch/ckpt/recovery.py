"""Fault-tolerance harness: restartable training, preemption, stragglers.

`ResilientLoop` wraps a step function with the production failure policy,
as `repro.ckpt.recovery` does:

  * periodic async checkpoints + resume-from-latest on (re)start;
  * SIGTERM/preemption hook → synchronous final checkpoint before exit;
  * bounded retry on transient step failure (a collective timeout, a device
    error): re-restore from the last complete VERIFIED checkpoint and replay
    — `latest_valid_step` hash-checks payloads, so a corrupt checkpoint
    behind a COMPLETE marker is walked past;
  * straggler watchdog (`repro_torch.guard.watchdog.StragglerWatchdog`,
    shared with the serving plane's quarantine breaker): a step slower than
    `straggler_factor`× the window median is logged with a re-shard
    recommendation.

A retry and a resume restore into new tensors on the devices of the state
they replace (`restore_checkpoint`).
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable

from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_valid_step,
    restore_checkpoint,
)
from repro_torch.guard.watchdog import StragglerWatchdog
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 2.0
    straggler_window: int = 32


class ResilientLoop:
    def __init__(
        self,
        step_fn: Callable[[Any, Any], tuple[Any, dict]],
        batch_fn: Callable[[int], Any],
        cfg: LoopConfig,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.watchdog = StragglerWatchdog(
            factor=cfg.straggler_factor, window=cfg.straggler_window)
        self._preempted = False

    # The watchdog owns the raw data; these aliases keep the loop's
    # reporting surface.
    @property
    def step_times(self) -> list[float]:
        return self.watchdog.step_times

    @property
    def straggler_events(self) -> list[dict]:
        return self.watchdog.events

    def _handle_preemption(self, signum, frame):
        self._preempted = True

    def resume_or_init(self, init_state_fn):
        last = latest_valid_step(self.cfg.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(self.cfg.ckpt_dir, last,
                                       init_state_fn())
            return state, last + 1
        return init_state_fn(), 0

    def run(
        self,
        state: Any,
        start_step: int,
        num_steps: int,
        *,
        on_metrics: Callable[[int, dict], None] | None = None,
        fail_injector: Callable[[int], None] | None = None,
    ) -> Any:
        old = signal.signal(signal.SIGTERM, self._handle_preemption)
        try:
            step = start_step
            retries = 0
            while step < start_step + num_steps:
                t0 = obs_trace.now()
                try:
                    if fail_injector is not None:
                        fail_injector(step)
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    retries = 0
                except Exception:
                    retries += 1
                    if retries > self.cfg.max_retries:
                        self.ckpt.wait()
                        raise
                    last = latest_valid_step(self.cfg.ckpt_dir)
                    if last is not None:
                        self.ckpt.wait()
                        state = restore_checkpoint(
                            self.cfg.ckpt_dir, last, state)
                        step = last + 1
                    continue

                self.watchdog.observe(step, obs_trace.now() - t0)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % self.cfg.ckpt_every == 0 or self._preempted:
                    self.ckpt.save(step, state)
                if self._preempted:
                    self.ckpt.wait()
                    break
                step += 1
            self.ckpt.wait()
            return state
        finally:
            signal.signal(signal.SIGTERM, old)
