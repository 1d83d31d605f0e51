"""Metrics registry — counters, gauges, histograms with p50/p95/p99.

The port of `repro.obs.metrics` (which imports no JAX), kept as a copy so
that the port imports nothing of the reference package; it reads the
port's own `SensorReport`, `ControlReport` and `GuardReport`.

One registry per observation scope (a serve run, a benchmark). Metrics are
keyed by (name, sorted label set), Prometheus-style, so the exporter can emit
them as a textfile and `repro_torch.obs.top` can render them live. Histograms keep
a bounded ring of recent samples (plus exact count/sum/min/max), so long
serve runs get recent-window percentiles at O(1) memory.

Aggregation helpers pull the existing telemetry sources into the registry:
`observe_sensor_report` (sensor counters → gauges), `observe_control_report`
(controller decisions → counters), and `observe_spans` (span durations →
histograms keyed by span name).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

_QUANTILES = (0.5, 0.95, 0.99)


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    name: str
    labels: dict[str, Any]
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    name: str
    labels: dict[str, Any]
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max over the full
    stream, percentiles over the most recent `window` samples."""

    def __init__(self, name: str, labels: dict[str, Any], *,
                 window: int = 4096):
        self.name = name
        self.labels = labels
        self.window = window
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._ring = np.zeros((window,), np.float64)
        self._n_ring = 0
        self._pos = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._ring[self._pos] = v
        self._pos = (self._pos + 1) % self.window
        self._n_ring = min(self._n_ring + 1, self.window)

    def percentile(self, q: float) -> float:
        """q in [0, 1] over the recent-sample window (0.0 when empty)."""
        if self._n_ring == 0:
            return 0.0
        return float(np.quantile(self._ring[: self._n_ring], q))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict[str, float]:
        out = {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }
        for q in _QUANTILES:
            out[f"p{int(q * 100)}"] = self.percentile(q)
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[tuple, Any] = {}

    def _get(self, cls, name: str, labels: dict[str, Any], **kw):
        key = (cls.__name__, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, labels, **kw)
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> list[dict[str, Any]]:
        """Plain-dict view of every metric — the exporter/`obs.top` input."""
        rows = []
        for m in self._metrics.values():
            row: dict[str, Any] = {
                "name": m.name,
                "labels": dict(m.labels),
                "type": type(m).__name__.lower(),
            }
            if isinstance(m, Histogram):
                row.update(m.summary())
            else:
                row["value"] = m.value
            rows.append(row)
        return rows


# ------------------------------------------------- telemetry-source adapters

def observe_sensor_report(registry: MetricsRegistry, report) -> None:
    """Sensor counters → gauges (model totals + per-site skip rates)."""
    model = report.model
    for key in ("mac_skip_rate", "tile_skip_rate", "weight_byte_skip_rate",
                "grid_step_skip_rate", "hit_rate"):
        if key in model:
            registry.gauge(f"reuse_{key}", scope="model").set(model[key])
    registry.gauge("reuse_steps", scope="model").set(model.get("steps", 0))
    for s in report.per_site:
        registry.gauge("reuse_site_tile_skip_rate", site=s.site).set(
            s.tile_skip_rate)
        registry.gauge("reuse_site_hit_rate", site=s.site).set(s.hit_rate)
        registry.gauge("reuse_site_overflow_fallbacks", site=s.site).set(
            s.overflow_fallbacks)


def observe_control_report(registry: MetricsRegistry, report) -> None:
    """Controller interval → decision counters by kind, retrace counter."""
    registry.counter("control_intervals").inc()
    for d in report.decisions:
        registry.counter("control_decisions", kind=d.kind).inc()
    if report.retrace:
        registry.counter("control_retraces").inc(len(report.retrace))


def observe_guard_report(registry: MetricsRegistry, report) -> None:
    """Guard-plane breaker pass → sentinel-trip counters by site and check,
    live quarantined-lane gauge, stall counter. The interesting alerting
    signal is `guard_sentinel_trips` staying at zero on healthy runs —
    the chaos CI job asserts the non-zero side."""
    for t in report.trips:
        registry.counter("guard_sentinel_trips",
                         site=t.site, check=t.check).inc()
    if report.stalled:
        registry.counter("guard_stall_windows").inc()
    registry.gauge("guard_quarantined_lanes").set(report.quarantined_lanes)


def observe_spans(registry: MetricsRegistry,
                  span_rows: Iterable[dict[str, Any]]) -> None:
    """Span durations → one histogram per span name (seconds)."""
    for row in span_rows:
        registry.histogram(f"span_{row['name']}_seconds").observe(
            row["dur_s"])
