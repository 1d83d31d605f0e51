"""Straggler watchdog — median-based step-latency anomaly detection.

The port of `repro.guard.watchdog`, whole (pure Python). The serving step
clock (`repro_torch.launch.serve` times each decode step) feeds it, and its
events feed the quarantine breaker's stall accounting: a stalled interval
never counts as "clean" for probation. A step slower than `factor`× the
median of the recent window is an event.

Median, not EMA, on purpose: one straggler must not drag the baseline it is
judged against (an EMA poisoned by the outlier stops flagging the next one).
"""

from __future__ import annotations

import statistics


class StragglerWatchdog:
    """Per-step wall-time monitor. `observe(step, dt)` returns an event dict
    when the step breached `factor`× the window median, else None. All events
    accumulate in `.events` for end-of-run reporting."""

    def __init__(
        self,
        *,
        factor: float = 2.0,
        window: int = 32,
        min_samples: int = 8,
        action: str = "recommend re-shard / evict host",
    ):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.action = action
        self.step_times: list[float] = []
        self.events: list[dict] = []

    def observe(self, step: int, dt: float) -> dict | None:
        self.step_times.append(dt)
        recent = self.step_times[-self.window:]
        if len(recent) < self.min_samples:
            return None
        med = statistics.median(recent)
        if dt > self.factor * med:
            event = {
                "step": step, "seconds": dt, "median": med,
                "action": self.action,
            }
            self.events.append(event)
            return event
        return None
