"""repro_torch.obs — tracing, metrics and the measured-latency plane.

The port of `repro.obs`, module for module:

* :mod:`repro_torch.obs.trace`   — host-side spans (`perf_counter`, an
  optional device synchronize at close, nestable, a shared no-op when
  disabled) that open `torch.profiler.record_function` and NVTX ranges, and
  the `--profile-dir` window (`torch.profiler`, a Chrome trace);
* :mod:`repro_torch.obs.events`  — correlation ids (run / session / request /
  window / replica) stamped onto spans, sensor rows and journal decisions;
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms
  (p50/p95/p99) aggregated from sensor counters, controller and guard
  reports and spans;
* :mod:`repro_torch.obs.export`  — Prometheus textfile + JSONL snapshots,
  and their parsers;
* :mod:`repro_torch.obs.latency` — the per-(site, layer, exec_path) MEASURED
  latency table, probed on the card through CUDA graphs of each path, and
  consumed by `repro_torch.tune.fit --latency-table` and the controller;
* ``python -m repro_torch.obs.top`` — a terminal view of a serve run's
  metrics snapshots (with ``--fleet``, per-replica columns and health);
* :mod:`repro_torch.obs.stream`, :mod:`~repro_torch.obs.fleet`,
  :mod:`~repro_torch.obs.slo` — the fleet plane: tailing readers, the
  aggregator with its `ReplicaHealth`, and the windowed SLO watch.

Everything but the probe is host-side; with tracing disabled (the default)
every instrumentation point is a shared no-op.
"""

from repro_torch.obs.events import (
    clear_ids,
    context,
    current_ids,
    new_run_id,
    set_ids,
    stamp,
)
from repro_torch.obs.fleet import (
    FleetAggregator,
    ReplicaHealth,
    export_fleet_metrics,
)
from repro_torch.obs.latency import (
    LatencyStat,
    LatencyTable,
    build_from_spans,
    load_latency_table,
    probe_latency_table,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    observe_control_report,
    observe_sensor_report,
)
from repro_torch.obs.slo import (
    SLOConfig,
    SLOWatcher,
    load_alerts,
)
from repro_torch.obs.stream import (
    ReplicaStream,
    TailCursor,
    discover_replica_streams,
    tail_jsonl,
)
from repro_torch.obs.trace import (
    disable,
    drain_spans,
    enable,
    is_enabled,
    now,
    span,
    spans,
    start_profile,
    stop_profile,
)

__all__ = [
    "Counter",
    "FleetAggregator",
    "Gauge",
    "Histogram",
    "LatencyStat",
    "LatencyTable",
    "MetricsRegistry",
    "ReplicaHealth",
    "ReplicaStream",
    "SLOConfig",
    "SLOWatcher",
    "TailCursor",
    "build_from_spans",
    "clear_ids",
    "context",
    "current_ids",
    "disable",
    "discover_replica_streams",
    "drain_spans",
    "enable",
    "export_fleet_metrics",
    "is_enabled",
    "load_alerts",
    "load_latency_table",
    "new_run_id",
    "now",
    "observe_control_report",
    "observe_sensor_report",
    "probe_latency_table",
    "set_ids",
    "spans",
    "span",
    "stamp",
    "start_profile",
    "stop_profile",
    "tail_jsonl",
]
