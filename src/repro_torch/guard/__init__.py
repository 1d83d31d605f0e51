"""repro_torch.guard — serving-plane fault containment (the port of
`repro.guard`).

ReuseSense's bet is that STALE STATE (cached products of a previous input)
can stand in for fresh computation, which makes the serving loop uniquely
exposed to state corruption: one poisoned prev_q/prev_out slot or a garbage
ctrl lane silently wrongs every output until the slot recycles. This package
is the containment plane:

* :mod:`repro_torch.guard.inject`     — deterministic, seeded fault injector
  with hooks at the real seams (cache post-update, ctrl block, retirement
  telemetry, journal writer, checkpoint dir, step clock). Each fault is a
  named scenario usable from tests and ``serve --inject <scenario>``.
* :mod:`repro_torch.guard.sentinel`   — cheap invariant checks that ride the
  engine's one control snapshot as device reductions (non-finite counts,
  ctrl-lane range validation, counter conservation) plus a periodic dense
  shadow spot-check against the bitwise oracle.
* :mod:`repro_torch.guard.quarantine` — the per-(site, layer) circuit
  breaker: tripped sentinel → lane pinned to basic, poisoned state
  scrubbed, all in place; replayable ``kind="quarantine"`` journal decision;
  probation with exponential backoff re-admits.
* :mod:`repro_torch.guard.watchdog`   — the median-based straggler watchdog
  on the serve step clock, feeding the same breaker.
"""

from repro_torch.guard.inject import SCENARIOS, FaultInjector
from repro_torch.guard.quarantine import (
    GuardConfig,
    GuardReport,
    QuarantineBreaker,
)
from repro_torch.guard.sentinel import (
    evaluate_snapshot,
    sentinel_lanes,
    shadow_check,
)
from repro_torch.guard.watchdog import StragglerWatchdog

__all__ = [
    "SCENARIOS",
    "FaultInjector",
    "GuardConfig",
    "GuardReport",
    "QuarantineBreaker",
    "StragglerWatchdog",
    "evaluate_snapshot",
    "sentinel_lanes",
    "shadow_check",
]
