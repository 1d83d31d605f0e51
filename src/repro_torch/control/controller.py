"""Controller — the host-side adaptive control plane for reuse serving.

The port of `repro.control.controller`, whole: the same loops, guardrails,
decisions and journal rows. What differs is how the engine applies them: a
spec change (block_k, exec path, budget) or a mode flip changes the compiled
step's decode key, so the next decode captures a CUDA graph for it or
replays the one of a known key (`serve/compiled_step.py`); every ctrl-lane
write goes into the existing tensors, which the graphs read.

Closes, on a background cadence INSIDE the serving loop (no JSONL round
trip), the three feedback loops the offline tooling only closed between
runs:

1. **online retuner** — per-site `SiteTunables` refit from windowed deltas of
   the live sensor counters through the same harvest model as
   `repro_torch.tune.fit`, with guardrails (min-samples floor, bounded step per
   interval, the engine's existing mode-flip cooldown) so one noisy window
   can never thrash the policy;
2. **budget adapter** — `max_active_k` widened/tightened from the measured
   `overflow_fallbacks` rate vs grid-step savings;
3. **admission predictor** — the attached :class:`AdmissionPredictor` learns
   per-session similarity from retirement telemetry; the controller journals
   its population estimate so admission drift is auditable.

Stacked sites get a second retune tier: each layer's own windowed counters
feed the same harvest model and land as "site@layer" ctrl-lane rows —
per-layer thresholds inside one stack, journaled per layer, applied as
ctrl-lane writes (no spec change).

`Controller.step(engine, cache)` returns a :class:`ControlReport`;
`report.changed` names the sites whose spec moved (the reference rebuilds
its jitted step exactly then). `ReuseEngine.refresh_modes` runs last, so
mode/exec transitions see the freshly-installed tunables and keep their
hysteresis + cooldown guardrails. Every move lands in the decision journal.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.control.admit import AdmissionPredictor
from repro_torch.control.budget import adapt_budget
from repro_torch.control.report import ControlReport, Decision, DecisionJournal
from repro_torch.control.retune import (
    bounded_tunables,
    snapshot_cache,
    window_layer_records,
    window_record,
)
from repro_torch.core.reuse_cache import resolve_exec_path
from repro_torch.tune.fit import fit_layer
from repro_torch.tune.harvest import FitConfig, measured_latency_note, solve_site

# SiteTunables fields the retuner may move, journaled field-by-field.
_TUNABLE_FIELDS = (
    "sim_threshold", "min_work_flops", "block_k",
    "hysteresis_margin", "hysteresis_steps", "exec_path", "max_active_k",
)
# The array-resident subset a per-layer ctrl-lane row may move (spec-level
# knobs stay site-granular — they are baked into the traced dispatch).
_LAYER_FIELDS = (
    "sim_threshold", "min_work_flops", "hysteresis_margin", "hysteresis_steps",
)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    # Guardrail: windows with fewer site evaluations than this are ignored
    # (not enough samples to act on).
    min_window_steps: int = 4
    # Guardrail: sim_threshold moves at most this far per interval.
    max_threshold_step: float = 0.10
    # Guardrail: min_work may only RISE by this factor per interval (lowering
    # — admission — applies immediately; see retune module docstring).
    max_min_work_raise: float = 8.0
    # Budget adapter: windowed overflow-fallback rate above which the
    # compacted-path budget widens by one block.
    widen_fallback_rate: float = 0.10
    # Budget adapter anti-thrash: tightening needs this many CONSECUTIVE
    # fallback-free windows (widening is immediate — every overflow forfeits
    # that step's whole grid saving, while a too-wide budget only walks some
    # extra steps). Prevents the boundary ping-pong where widen/tighten
    # alternate and each move costs a jitted-step retrace.
    tighten_clean_windows: int = 2
    # Re-entering a budget that previously OVERFLOWED (the floor a widen
    # recorded) needs this much longer a clean streak — a boundary stream
    # whose peaks keep tripping the floor resets the streak and never
    # re-tries the known-bad budget, while a genuinely-calmed stream earns
    # the retry after a sustained quiet run.
    tighten_floor_streak: int = 8
    # Journal an "admit" decision when the predictor's population estimate
    # moved by at least this much since the last interval.
    admit_report_eps: float = 0.05
    # Decision-journal JSONL path (None = in-memory only).
    journal_path: str | None = None
    # The shared harvest model's settings (same dataclass the offline fitter
    # takes — one cost model, one config surface). Its `pallas_target` is
    # ignored: the controller derives it from engine.impl each step so pins
    # always match the substrate the engine executes.
    fit: FitConfig = dataclasses.field(default_factory=FitConfig)
    # Measured per-(site, layer, exec_path) latency table to price retunes
    # from (an `obs_latency_table` JSON — serve --obs-dir writes one). Loaded
    # at Controller construction and injected into the harvest model; every
    # decision it influences carries the measured evidence in its reason.
    latency_table_path: str | None = None


class Controller:
    """Online adaptive control plane. One instance per serving engine."""

    def __init__(
        self,
        config: ControlConfig = ControlConfig(),
        *,
        admission: AdmissionPredictor | None = None,
        journal: DecisionJournal | None = None,
        latency=None,
        guard=None,
    ):
        self.config = config
        self.admission = admission
        # Optional guard-plane breaker (the reference's
        # repro.guard.QuarantineBreaker): runs FIRST each interval
        # (containment before adaptation — retuning a poisoned window would
        # learn from garbage), its decisions merge into the one journal
        # stream, and sites it froze are skipped by the retuner this interval.
        self.guard = guard
        self.last_guard_report = None
        if journal is None and config.journal_path:
            journal = DecisionJournal(config.journal_path)
        self.journal = journal
        if latency is None and config.latency_table_path:
            from repro_torch.obs.latency import load_latency_table

            latency = load_latency_table(config.latency_table_path)
        self.latency = latency  # obs LatencyTable or None (constant pricing)
        self.reports: list[ControlReport] = []
        self._snaps: dict[str, dict] = {}
        # per-site (skipped_shard, computed_shard) cumulative lanes from the
        # engine's last ctrl snapshot — diffed per interval for the journal's
        # per-shard skip-rate rows (no extra device_get: the lanes ride the
        # snapshot the refresh already pulled)
        self._shard_snaps: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._shard_rates: dict[tuple[str, int], float] = {}
        self._clean_windows: dict[str, int] = {}  # per-site fallback-free run
        # per-site budget value observed to overflow (set on widen); units
        # are K-blocks of the block_k the widen happened at
        self._budget_floor: dict[str, int] = {}
        self._interval = 0
        self._last_admit_est: float | None = None

    def step(self, engine, cache: dict[str, Any], *,
             step: int | None = None) -> ControlReport:
        """One control interval: harvest window deltas, retune, adapt
        budgets, refresh modes/exec paths, journal everything."""
        cfg = self.config
        self._interval += 1
        step = self._interval if step is None else step
        decisions: list[Decision] = []
        windows: dict[str, int] = {}
        retrace: dict[str, str] = {}
        # The solver must fit the substrate family the engine actually
        # executes: a Pallas engine compacts onto the ragged grid kernel,
        # jnp onto the gathered GEMM. A config-static pallas_target that
        # mismatched engine.impl would pin the wrong path — and pins
        # override decide_exec_path unconditionally.
        fit_cfg = dataclasses.replace(
            cfg.fit, pallas_target=(engine.impl != "jnp"),
            latency=self.latency if self.latency is not None else
            cfg.fit.latency,
        )

        # -- loop 0: fault containment BEFORE adaptation. The breaker reads
        # the sentinel lanes riding the same ctrl snapshot, pins tripped
        # lanes to basic, scrubs poisoned state, and journals the
        # transitions; retuning a site it froze this interval would fit the
        # harvest model to a poisoned window, so those sites sit out.
        frozen: set[str] = set()
        self.last_guard_report = None
        if self.guard is not None:
            guard_report = self.guard.step(engine, cache, step=step)
            self.last_guard_report = guard_report
            decisions.extend(guard_report.decisions)
            frozen = guard_report.frozen_sites

        shards = getattr(engine, "shards", None) or {}
        stacking = getattr(engine, "stacking", None) or {}
        # every site's counters in ONE device→host transfer, model-sharded
        # sites collapsed on the host (the sensor counters move only in
        # decode steps, so reading them all before the loop sees what the
        # reference's per-site reads see)
        snaps = snapshot_cache(cache, list(engine.sites), shard_axes={
            name: 1 if stacking.get(name, 0) else 0 for name in shards},
            placement=getattr(engine, "placement", None))
        for name, spec in list(engine.sites.items()):
            cur = snaps[name]
            if cur is None:
                continue
            if name in frozen:
                # reset the window baseline: the pre-containment half of the
                # window measured a poisoned site
                self._snaps[name] = cur
                continue
            prev = self._snaps.get(name)
            if prev is None:
                self._snaps[name] = cur  # first sight: window starts now
                continue
            rec = window_record(
                name, spec, engine.site_mode(cache, name),
                resolve_exec_path(spec, engine.impl), prev, cur,
            )
            if rec is None or rec.steps < cfg.min_window_steps:
                # below the min-samples floor: keep the old snapshot so the
                # window keeps ACCUMULATING across intervals instead of
                # being discarded (any cadence eventually clears the floor)
                continue
            self._snaps[name] = cur
            windows[name] = rec.steps

            # -- loop 1: online retune through the shared harvest model.
            # When a measured latency table covers the site, the solve is
            # priced from observed wall-clock and the evidence is appended
            # to every decision it produces.
            current_t = engine.policy.resolve(name)
            target = solve_site(rec, fit_cfg)
            meas_note = measured_latency_note(rec, fit_cfg)
            meas_sfx = f" [{meas_note}]" if meas_note else ""
            bounded, reasons = bounded_tunables(
                current_t, target,
                current_block_k=spec.block_k,
                max_threshold_step=cfg.max_threshold_step,
                max_min_work_raise=cfg.max_min_work_raise,
            )
            if bounded != current_t:
                spec_changed = engine.apply_tunables(name, bounded, cache)
                if spec_changed:
                    retrace[name] = "retune"
                for f in _TUNABLE_FIELDS:
                    b, a = getattr(current_t, f), getattr(bounded, f)
                    if f == "block_k" and b is None:
                        # a table entry's block_k=None defers to the spec:
                        # journal against the EFFECTIVE granularity, not the
                        # sentinel, or every first window logs a phantom move
                        b = spec.block_k
                    if b != a:
                        # a reason's first token is the knob it explains
                        # ("min_work ..." explains min_work_flops); fields
                        # without their own reason (hysteresis, the budget
                        # riding an exec promotion) get the interval blob
                        why = next(
                            (r for r in reasons
                             if f.startswith(r.split(" ", 1)[0])),
                            "; ".join(reasons) or "refit",
                        )
                        decisions.append(Decision(
                            step=step, site=name, kind="retune", field=f,
                            before=b, after=a,
                            reason=f"window {rec.steps} steps, "
                                   f"hit {rec.hit_rate:.2f}, "
                                   f"skip {rec.tile_skip_rate:.2f}: "
                                   f"{why}{meas_sfx}",
                        ))

            # a block_k retune rescales the spec budget (same covered K
            # extent, new units) — journal it or replaying the journal would
            # reconstruct a budget covering half the real extent
            spec_after = engine.sites[name]
            if (spec_after.max_active_k != spec.max_active_k
                    and bounded.max_active_k == current_t.max_active_k):
                decisions.append(Decision(
                    step=step, site=name, kind="retune", field="max_active_k",
                    before=spec.max_active_k, after=spec_after.max_active_k,
                    reason=f"rescaled with block_k {spec.block_k}->"
                           f"{spec_after.block_k} (same covered K extent)",
                ))

            # -- loop 1b: per-layer ctrl-lane retune for stacked sites —
            # each layer's own windowed operating point through the SAME
            # harvest model, bounded exactly like the site move, installed
            # as a "site@layer" row (an array write into the ctrl block, so
            # NO retrace) and journaled per layer.
            layer_recs = window_layer_records(
                name, spec_after, engine.layer_modes(cache, name),
                resolve_exec_path(spec_after, engine.impl), prev, cur,
            )
            layers_moved = False
            for lyr, lrec in sorted(layer_recs.items()):
                if lrec.steps < cfg.min_window_steps:
                    continue
                cur_l = engine.policy.resolve(name, layer=lyr)
                bounded_l, reasons_l = bounded_tunables(
                    cur_l, fit_layer(lrec, fit_cfg),
                    current_block_k=spec_after.block_k,
                    max_threshold_step=cfg.max_threshold_step,
                    max_min_work_raise=cfg.max_min_work_raise,
                )
                moved = {
                    f: (getattr(cur_l, f), getattr(bounded_l, f))
                    for f in _LAYER_FIELDS
                    if getattr(cur_l, f) != getattr(bounded_l, f)
                }
                if not moved:
                    continue
                # cache=None: lane sync deferred to ONE pass after the loop
                # (per-layer sync would rebuild all L lanes per moved layer)
                engine.apply_tunables(name, bounded_l, layer=lyr)
                layers_moved = True
                for f, (b, a) in moved.items():
                    why = next(
                        (r for r in reasons_l
                         if f.startswith(r.split(" ", 1)[0])),
                        "; ".join(reasons_l) or "refit",
                    )
                    note_l = measured_latency_note(lrec, fit_cfg)
                    decisions.append(Decision(
                        step=step, site=name, kind="retune", field=f,
                        before=b, after=a, layer=lyr,
                        reason=f"layer window {lrec.steps} steps, "
                               f"hit {lrec.hit_rate:.2f}, "
                               f"skip {lrec.tile_skip_rate:.2f}: {why}"
                               + (f" [{note_l}]" if note_l else ""),
                    ))
            if layers_moved:
                engine._sync_ctrl(name, cache)

            # -- loop 2: budget adaptation from measured overflow fallbacks
            spec = spec_after  # retune may have replaced it
            if rec.block_k != spec.block_k:
                # floor units are K-blocks of the old granularity: stale
                self._budget_floor.pop(name, None)
            if rec.overflow_fallbacks == 0:
                self._clean_windows[name] = self._clean_windows.get(name, 0) + 1
            else:
                self._clean_windows[name] = 0
            proposal = adapt_budget(
                spec, rec,
                n_layers=engine.stacking.get(name, 0) or 1,
                widen_fallback_rate=cfg.widen_fallback_rate,
            )
            if proposal is not None:
                new_budget, why = proposal
                before = spec.max_active_k
                tightening = before is not None and new_budget < before
                if tightening:
                    # anti-thrash: any tighten needs a clean-window streak,
                    # and re-entering a budget that previously overflowed
                    # (the recorded floor) needs a much longer one — else a
                    # boundary stream ping-pongs widen/tighten, paying a
                    # retrace per move
                    need = cfg.tighten_clean_windows
                    floor = self._budget_floor.get(name)
                    if floor is not None and new_budget <= floor:
                        need = cfg.tighten_floor_streak
                    if self._clean_windows[name] < need:
                        proposal = None
                if proposal is not None and engine.set_budget(name, new_budget):
                    retrace[name] = "budget"
                    if new_budget > (before or 0):
                        self._budget_floor[name] = before or 0
                    decisions.append(Decision(
                        step=step, site=name, kind="budget",
                        field="max_active_k", before=before,
                        after=engine.sites[name].max_active_k, reason=why,
                    ))

        # -- hysteretic mode/exec refresh sees the freshly-installed tunables.
        # Mode flips are per-layer ctrl-array writes (journaled from the
        # engine's event list, NO retrace); only exec-path flips — spec
        # changes — come back in the refresh result and force a rebuild.
        # The refresh also rides every interval where the guard is watching a
        # non-active lane: recovery from quarantine (cooldown drain, mode
        # re-promotion) must not wait for the retuner to accumulate a
        # min-samples window.
        guard_watch = self.guard is not None and any(
            st != "active" for st in self.guard.lane_states().values())
        if windows or guard_watch:
            paths_before = {n: s.exec_path for n, s in engine.sites.items()}
            for name, what in engine.refresh_modes(cache).items():
                retrace[name] = what
                decisions.append(Decision(
                    step=step, site=name, kind="exec", field="exec_path",
                    before=paths_before[name],
                    after=engine.sites[name].exec_path,
                    reason="measured skip rate crossed the compaction "
                           "break-even (refresh_exec_paths)",
                ))
            for ev in engine.last_mode_events:
                decisions.append(Decision(
                    step=step, site=ev["site"], kind="mode", field="mode",
                    before=ev["before"], after=ev["after"], layer=ev["layer"],
                    reason="hysteretic per-layer decide_modes on live "
                           f"sim_ema {ev['sim_ema']:.2f} (ctrl-array write, "
                           "no retrace)",
                ))

        # -- per-shard skip truth from the windowed cross-mesh reduce. The
        # cumulative skipped_shard/computed_shard lanes ([S]) ride the ctrl
        # snapshot the refresh just pulled (engine.last_snapshot), so this
        # costs zero extra transfers; each shard whose windowed rate moved
        # journals ONE kind="shard" observation row — per-shard skip rates
        # alongside the single global knob trajectory, as the mesh design
        # requires. These rows move no knob (replay chains, applies nothing).
        last_snap = getattr(engine, "last_snapshot", None)
        if windows and shards and last_snap:
            for name in sorted(shards):
                if name not in windows:
                    continue
                s = last_snap.get(name, {})
                sk, co = s.get("skipped_shard"), s.get("computed_shard")
                if sk is None or co is None:
                    continue
                sk = np.asarray(sk, np.int64)
                co = np.asarray(co, np.int64)
                prev_lanes = self._shard_snaps.get(name)
                self._shard_snaps[name] = (sk, co)
                if prev_lanes is None:
                    continue  # first sight: window starts now
                d_sk, d_co = sk - prev_lanes[0], co - prev_lanes[1]
                for sh in range(sk.shape[0]):
                    tot = float(d_sk[sh] + d_co[sh])
                    if tot <= 0:
                        continue
                    rate = round(float(d_sk[sh]) / tot, 6)
                    before = self._shard_rates.get((name, sh))
                    if before == rate:
                        continue
                    self._shard_rates[(name, sh)] = rate
                    decisions.append(Decision(
                        step=step, site=name, kind="shard", field="skip_rate",
                        before=before, after=rate, shard=sh,
                        reason=f"windowed cross-mesh reduce: "
                               f"{int(d_sk[sh])}/{int(tot)} owned tiles "
                               f"skipped on shard {sh}",
                    ))

        # -- loop 3: admission predictor drift, journaled
        admission = None
        if self.admission is not None:
            admission = self.admission.stats()
            est = admission["global_est"]
            last = self._last_admit_est
            if last is None or abs(est - last) >= cfg.admit_report_eps:
                if last is not None:
                    decisions.append(Decision(
                        step=step, site="", kind="admit", field="global_est",
                        before=round(last, 4), after=round(est, 4),
                        reason=f"{admission['observations']} retirements "
                               f"across {admission['n_sessions']} sessions",
                    ))
                self._last_admit_est = est

        report = ControlReport(
            step=step, interval=self._interval, window_steps=windows,
            decisions=decisions, retrace=retrace, admission=admission,
        )
        self.reports.append(report)
        if self.journal is not None:
            self.journal.append(report)
        return report
