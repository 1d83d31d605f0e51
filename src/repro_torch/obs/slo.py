"""Windowed SLO / anomaly watch over a :class:`FleetAggregator`.

The port of `repro.obs.slo`, a copy: the same rules, rows and counters.

A router must not learn about a limping replica by routing traffic
into it. This watcher turns the fleet rollup into explicit, attributed alert
rows — journal-style JSONL, same torn-tail tolerance on read — plus
Prometheus counters on the shared registry:

* **skip collapse** — a replica's windowed mac_skip falls below
  ``collapse_frac`` of its *own* trailing baseline for
  ``collapse_consecutive`` consecutive sensor windows. Watched at replica
  level AND per site: one quarantined lane on an 8-lane model only dents
  replica-level skip by ~1/8, but halves its 2-layer site — per-site watch
  is what makes a single-lane containment visible.
* **p95 burn** — measured ``serve_step`` span p95 exceeds the configured
  target (off unless a target is set).
* **quarantine spike** — the replica's quarantined-lane count rose since the
  last evaluation (the guard contained something; the router should know
  before the skip trend shows it).

Alerts fire once per episode (condition must clear before the same key can
alert again), so a sustained collapse is one row, not one per window.
Every alert is attributed to exactly one replica — the acceptance bar is a
clean replica staying alert-free while an injected one is named.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from repro_torch.obs.fleet import FleetAggregator
from repro_torch.obs.stream import TailCursor, tail_jsonl

ALERT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class SLOConfig:
    """Thresholds for the fleet watch plane."""

    collapse_frac: float = 0.6        # window skip < frac * baseline => bad
    collapse_consecutive: int = 2     # bad windows in a row before alerting
    min_baseline_skip: float = 0.05   # don't judge a replica still warming up
    p95_target_s: float | None = None  # serve_step p95 burn target (off=None)
    p95_min_count: int = 5            # spans needed before p95 is judged
    quarantine_spike_lanes: int = 1   # lane-count rise that triggers an alert


class SLOWatcher:
    """Evaluate SLO rules against an aggregator after each poll.

    Call :meth:`evaluate` whenever the aggregator has consumed new rows;
    it returns only the alerts newly raised by that evaluation. Alerts are
    appended to ``alerts_path`` (journal-style JSONL) when given, counted
    into ``registry`` as ``fleet_alerts_total{alert=...,replica=...}``, and
    fed back into the aggregator's per-replica health via ``note_alert``.
    """

    def __init__(self, agg: FleetAggregator,
                 config: SLOConfig | None = None, *,
                 registry=None, alerts_path: str | None = None):
        self.agg = agg
        self.config = config or SLOConfig()
        self.registry = registry
        self.alerts_path = alerts_path
        self.alerts: list[dict[str, Any]] = []
        # episode state, keyed (replica, rule-site key)
        self._streak: dict[tuple[str, str], int] = {}
        self._active: set[tuple[str, str]] = set()
        self._last_window: dict[str, int] = {}
        self._last_lanes: dict[str, int] = {}

    # ------------------------------------------------------------------ emit
    def _emit(self, replica: str, alert_kind: str, *,
              site: str = "", value: float = 0.0, baseline: float = 0.0,
              threshold: float = 0.0, window: int = 0,
              detail: str = "") -> dict[str, Any]:
        row = {
            "kind": "alert",
            "schema_version": ALERT_SCHEMA_VERSION,
            "alert_kind": alert_kind,
            "replica": replica,
            "site": site,
            "window": window,
            "value": value,
            "baseline": baseline,
            "threshold": threshold,
            "detail": detail,
        }
        agg_rep = self.agg.replicas.get(replica)
        if agg_rep and agg_rep.runs:
            row["run"] = agg_rep.runs[-1]
        self.alerts.append(row)
        self.agg.note_alert(replica)
        if self.registry is not None:
            self.registry.counter(
                "fleet_alerts_total", alert=alert_kind,
                replica=replica).inc()
        if self.alerts_path:
            with open(self.alerts_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    # -------------------------------------------------------------- evaluate
    def evaluate(self) -> list[dict[str, Any]]:
        """Run every rule once; return the alerts raised by this pass."""
        before = len(self.alerts)
        for replica in sorted(self.agg.replicas):
            agg = self.agg.replicas[replica]
            fresh_window = agg.windows > self._last_window.get(replica, 0)
            self._last_window[replica] = agg.windows
            if fresh_window:
                self._check_collapse(
                    replica, "", list(agg.window_skips), agg.windows)
                for site in sorted(agg.site_window_skips):
                    self._check_collapse(
                        replica, site,
                        list(agg.site_window_skips[site]), agg.windows)
            self._check_p95(replica, agg)
            self._check_quarantine(replica, agg)
        return self.alerts[before:]

    def _check_collapse(self, replica: str, site: str,
                        skips: list[float], window: int) -> None:
        cfg = self.config
        key = (replica, site or "<replica>")
        if len(skips) < 2:
            return
        current, prior = skips[-1], skips[:-1]
        baseline = sum(prior) / len(prior)
        if baseline < cfg.min_baseline_skip:
            # still warming up (or a never-skipping lane): no baseline to
            # collapse from, and clearing the streak keeps warm-up noise out
            self._streak[key] = 0
            return
        if current < cfg.collapse_frac * baseline:
            self._streak[key] = self._streak.get(key, 0) + 1
            if self._streak[key] >= cfg.collapse_consecutive and \
                    key not in self._active:
                self._active.add(key)
                self._emit(
                    replica, "skip_collapse", site=site, value=current,
                    baseline=baseline,
                    threshold=cfg.collapse_frac, window=window,
                    detail=(f"windowed mac_skip {current:.3f} < "
                            f"{cfg.collapse_frac:.2f}x trailing baseline "
                            f"{baseline:.3f} for {self._streak[key]} "
                            f"consecutive windows"
                            + (f" at site {site}" if site else "")))
        else:
            self._streak[key] = 0
            self._active.discard(key)

    def _check_p95(self, replica: str, agg) -> None:
        cfg = self.config
        if cfg.p95_target_s is None:
            return
        durs = agg.span_durs.get("serve_step", ())
        if len(durs) < cfg.p95_min_count:
            return
        p95 = agg.span_quantile("serve_step", 0.95)
        key = (replica, "<p95>")
        if p95 > cfg.p95_target_s:
            if key not in self._active:
                self._active.add(key)
                self._emit(
                    replica, "p95_burn", value=p95,
                    threshold=cfg.p95_target_s, window=agg.windows,
                    detail=(f"serve_step p95 {p95 * 1e3:.2f}ms over target "
                            f"{cfg.p95_target_s * 1e3:.2f}ms "
                            f"(n={len(durs)})"))
        else:
            self._active.discard(key)

    def _check_quarantine(self, replica: str, agg) -> None:
        lanes = agg.quarantined_lanes()
        last = self._last_lanes.get(replica, 0)
        self._last_lanes[replica] = lanes
        if lanes - last >= self.config.quarantine_spike_lanes:
            self._emit(
                replica, "quarantine_spike", value=lanes, baseline=last,
                threshold=self.config.quarantine_spike_lanes,
                window=agg.windows,
                detail=(f"quarantined lanes rose {last} -> {lanes}"))


def load_alerts(path: str) -> list[dict[str, Any]]:
    """Read an alert JSONL file, forgiving a torn final line (the watcher
    may have died mid-append) like `load_journal` does."""
    if not os.path.exists(path):
        return []
    return tail_jsonl(path, TailCursor(), final=True)
