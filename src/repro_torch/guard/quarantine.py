"""Quarantine breaker — per-(site, layer) fault containment state machine.

The port of `repro.guard.quarantine`, whole: the same lifecycle, decisions
and journal rows. A tripped sentinel must not keep wronging outputs until
the slot recycles, so the breaker flips the offending lane to basic THE SAME
control interval the evidence lands: `engine.set_mode` (the ctrl lane and
its host mirror) plus a `quarantine` ctrl-lane write, the poisoned state
scrubbed (prev_q/prev_out/sim_ema lanes zeroed, the ctrl lanes rebuilt from
the policy table; the cold-start property — reuse == quantized dense on the
first step after a zeroed lane — makes the scrub exact, the same guarantee
slot recycling leans on), and a replayable `kind="quarantine"` decision with
the sentinel evidence lands in the decision journal.

Every write goes into the existing tensors (`zero_`, `fill_`, indexed
assignment, `add_`): the compiled step's CUDA graphs read the tensors they
were captured on. The mode write moves the decode key (`serve/
compiled_step.py`), so the step after a trip or a re-promotion may capture.

Lifecycle per lane::

    active ──trip──▶ quarantined ──lockout drains──▶ probation ──K clean──▶ active
                        ▲                                │
                        └────────── re-offense ──────────┘   (lockout doubles)

The lockout is `quarantine_intervals` control intervals, doubling on every
re-offense up to `max_quarantine` (exponential backoff: a lane that keeps
tripping converges to permanently-basic). Cross-freeze: a quarantine bumps
the lane's mode cooldown AND the site's exec cooldown, so neither the
hysteretic refresh nor the retuner can thrash against the breaker — and the
controller skips retuning a site the breaker froze this interval. A stalled
interval (the straggler watchdog fired) never counts as "clean" for
probation: a replica limping on latency has not proven itself healthy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.control.report import Decision
from repro_torch.guard.sentinel import Trip, evaluate_snapshot, shadow_check


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    # Initial lockout length, in control intervals, for a first offense.
    quarantine_intervals: int = 2
    # Lockout growth on re-offense (doubles) is capped here.
    max_quarantine: int = 64
    # Clean (trip-free, stall-free) probation intervals before re-admission.
    probation_windows: int = 2
    # Run the dense shadow spot-check every N intervals (0 = disabled). One
    # site per eligible interval, round-robin — the check costs two real site
    # evaluations, so it must not run per site per interval.
    shadow_every: int = 0
    shadow_batch: int = 2
    shadow_seed: int = 0


@dataclasses.dataclass
class _Lane:
    state: str = "active"        # active | quarantined | probation
    lockout: int = 2             # current lockout length (doubles on re-offense)
    remaining: int = 0           # lockout intervals left while quarantined
    clean: int = 0               # clean probation intervals so far
    offenses: int = 0


@dataclasses.dataclass
class GuardReport:
    """What one breaker pass saw and did."""

    step: int
    interval: int
    trips: list[Trip]
    decisions: list[Decision]
    # sites the breaker acted on this interval — the retuner must skip them
    frozen_sites: set[str]
    stalled: bool
    shadow: tuple[str, bool, str] | None = None  # (site, ok, detail)
    quarantined_lanes: int = 0  # live count after this pass

    @property
    def tripped(self) -> bool:
        return bool(self.trips)


class QuarantineBreaker:
    """Host-side circuit breaker fed by the array sentinels. One instance per
    serving engine; invoke `step(engine, cache, step=...)` once per control
    interval (the Controller does this first, before retuning)."""

    def __init__(self, config: GuardConfig = GuardConfig()):
        self.config = config
        self._lanes: dict[tuple[str, int | None], _Lane] = {}
        # previous interval's counter lanes + geometry, for the windowed
        # conservation check (a block_k move invalidates one window)
        self._prev_lanes: dict[str, dict[str, np.ndarray]] = {}
        self._prev_block_k: dict[str, int] = {}
        self._pending_stalls: list[dict] = []
        self.stall_windows = 0
        self._interval = 0
        self._shadow_idx = 0
        self.total_trips = 0

    # ------------------------------------------------------------ stall input
    def note_stall(self, event: dict) -> None:
        """Feed a straggler-watchdog event (serve times each decode step);
        journaled and counted against probation on the next `step`."""
        self._pending_stalls.append(event)

    # ------------------------------------------------------------- inspection
    def lane_states(self) -> dict[tuple[str, int | None], str]:
        return {k: v.state for k, v in self._lanes.items()}

    def quarantined_lanes(self) -> int:
        return sum(1 for v in self._lanes.values() if v.state == "quarantined")

    # ------------------------------------------------------------------- pass
    def step(self, engine, cache: dict[str, Any], *, step: int,
             snapshot: dict[str, Any] | None = None) -> GuardReport:
        cfg = self.config
        self._interval += 1
        snap = snapshot if snapshot is not None else engine.ctrl_snapshot(
            cache, sentinels=True)
        decisions: list[Decision] = []
        trips: list[Trip] = []
        frozen: set[str] = set()

        # -- stall accounting first: a stalled interval voids probation credit
        stalled = bool(self._pending_stalls)
        for ev in self._pending_stalls:
            decisions.append(Decision(
                step=step, site="", kind="quarantine", field="stall_windows",
                before=self.stall_windows, after=self.stall_windows + 1,
                reason=f"straggler watchdog: step {ev['step']} took "
                       f"{ev['seconds']:.4f}s vs median {ev['median']:.4f}s "
                       f"({ev['action']})",
            ))
            self.stall_windows += 1
        self._pending_stalls = []

        # -- array sentinels per site (lanes already ride the one snapshot)
        for name, spec in engine.sites.items():
            s = snap.get(name, {})
            if "bad_out" not in s:
                continue  # entry without the guard lanes
            stacked = engine.stacking.get(name, 0) > 0
            batch = cache[name]["prev_q"].shape[-2]
            gm = -(-batch // spec.block_m)
            gk = -(-spec.in_features // spec.block_k)
            prev = self._prev_lanes.get(name)
            tiles = gm * gk
            if self._prev_block_k.get(name) != spec.block_k:
                tiles = None  # geometry moved: this window's delta mixes units
            trips += evaluate_snapshot(
                name, s, stacked=stacked, tiles_per_eval=tiles, prev=prev,
            )
            self._prev_lanes[name] = {
                k: np.asarray(s[k])
                for k in ("skipped_l", "computed_l", "steps_l") if k in s
            }
            self._prev_block_k[name] = spec.block_k

        # -- periodic dense shadow spot-check, one site round-robin
        shadow = None
        if cfg.shadow_every > 0 and self._interval % cfg.shadow_every == 0:
            sites = sorted(engine.sites)
            if sites:
                site = sites[self._shadow_idx % len(sites)]
                self._shadow_idx += 1
                ok, detail = shadow_check(
                    engine, site, batch=cfg.shadow_batch,
                    seed=cfg.shadow_seed + self._interval,
                )
                shadow = (site, ok, detail)
                if not ok:
                    trips.append(Trip(site=site, layer=None, check="shadow",
                                      evidence=detail))

        # -- breaker: trips → quarantine writes + journal decisions
        by_lane: dict[tuple[str, int | None], list[Trip]] = {}
        for t in trips:
            by_lane.setdefault((t.site, t.layer), []).append(t)
        for (site, layer), lane_trips in sorted(
                by_lane.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            lane = self._lanes.setdefault(
                (site, layer), _Lane(lockout=cfg.quarantine_intervals))
            before = lane.state
            if lane.offenses > 0:
                # any re-offense — out of probation, while locked, or after a
                # full re-admission — doubles the lockout (backoff)
                lane.lockout = min(lane.lockout * 2, cfg.max_quarantine)
            lane.state = "quarantined"
            lane.remaining = lane.lockout
            lane.clean = 0
            lane.offenses += 1
            self.total_trips += len(lane_trips)
            self._apply_quarantine(engine, cache, site, layer, lane.lockout)
            decisions.append(Decision(
                step=step, site=site, kind="quarantine", field="state",
                before=before, after="quarantined", layer=layer,
                reason="; ".join(f"{t.check}: {t.evidence}"
                                 for t in lane_trips)
                       + f" [lockout {lane.lockout} intervals, "
                         f"offense #{lane.offenses}]",
            ))
            frozen.add(site)

        # -- drain lockouts / advance probation for lanes NOT tripped now
        for (site, layer), lane in sorted(
                self._lanes.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            if (site, layer) in by_lane:
                continue
            if lane.state == "quarantined":
                frozen.add(site)  # still locked: retuner keeps hands off
                lane.remaining -= 1
                self._write_ctrl_lane(
                    cache, site, layer, quarantine=max(lane.remaining, 0))
                if lane.remaining <= 0:
                    lane.state = "probation"
                    lane.clean = 0
                    decisions.append(Decision(
                        step=step, site=site, kind="quarantine",
                        field="state", before="quarantined",
                        after="probation", layer=layer,
                        reason=f"lockout drained after {lane.lockout} "
                               f"intervals; needs {cfg.probation_windows} "
                               f"clean windows to re-admit",
                    ))
            elif lane.state == "probation":
                if stalled:
                    lane.clean = 0  # a limping interval proves nothing
                    continue
                lane.clean += 1
                if lane.clean >= cfg.probation_windows:
                    lane.state = "active"
                    decisions.append(Decision(
                        step=step, site=site, kind="quarantine",
                        field="state", before="probation", after="active",
                        layer=layer,
                        reason=f"re-admitted after {lane.clean} clean "
                               f"windows; next offense locks out "
                               f"{min(lane.lockout * 2, cfg.max_quarantine)} "
                               f"intervals",
                    ))

        return GuardReport(
            step=step, interval=self._interval, trips=trips,
            decisions=decisions, frozen_sites=frozen, stalled=stalled,
            shadow=shadow, quarantined_lanes=self.quarantined_lanes(),
        )

    # ------------------------------------------------------------ lane writes
    def _apply_quarantine(
        self, engine, cache: dict[str, Any], site: str, layer: int | None,
        lockout: int,
    ) -> None:
        """Contain one lane: pin basic, scrub poisoned state, rebuild ctrl
        lanes from the policy table, cross-freeze mode/exec cooldowns, bump
        the sentinel-trip counter. Every write in place."""
        engine.set_mode(cache, site, "basic", layer=layer)
        entry = cache[site]
        for key in ("prev_q", "prev_out", "sim_ema"):
            arr = entry[key]
            (arr if layer is None else arr[layer]).zero_()
        sensor = entry.get("sensor")
        if sensor is not None and "sentinel_trips" in sensor:
            st = sensor["sentinel_trips"]
            if layer is None or st.ndim == 0:
                st.add_(1)
            else:
                st[layer].add_(1)
        # rebuild the lane's ctrl operating point from the policy table (a
        # ctrl_range trip means these very lanes may be garbage)
        stacked = engine.stacking.get(site, 0) > 0
        t = engine.policy.resolve(site, layer=layer if stacked else None)
        self._write_ctrl_lane(
            cache, site, layer,
            sim_threshold=t.sim_threshold,
            min_work=t.min_work_flops,
            occupancy=1.0,
            cooldown=lockout,
            quarantine=lockout,
        )
        # the reciprocal freeze the mode/exec refreshes already practice:
        # containment must not thrash against the retuner's exec decisions
        engine.exec_cooldown[site] = max(
            engine.exec_cooldown.get(site, 0), lockout)

    @staticmethod
    def _write_ctrl_lane(
        cache: dict[str, Any], site: str, layer: int | None, **values: Any,
    ) -> None:
        ctrl = cache[site]["ctrl"]
        for key, val in values.items():
            arr = ctrl.get(key)
            if arr is None:
                continue  # legacy ctrl block without the lane
            if layer is None:
                arr.fill_(val)
            else:
                arr[layer] = val
