"""Fleet aggregation — N replica event streams merged into one rollup.

The port of `repro.obs.fleet`. Energy is priced through the port's
`sensor.cost_model`, whose per-op constants are the reference's.

A fleet of serving replicas needs two observables no single-process plane
provides: fleet-level skip/energy from sensor aggregation, and per-replica
health (quarantined lanes, stall windows, skip trend) as router placement
signals. :class:`FleetAggregator` provides both by merging N
:class:`~repro_torch.obs.stream.ReplicaStream` tails:

* aggregation stays replica-local (compute near the data) — each replica
  reduces its own counters into its own obs dir, and only those compact
  rollup rows cross the process boundary into the fleet plane; the
  aggregator never touches device state;
* per-(replica, site, layer) rollups come straight from the replicas' sensor
  rows; fleet-level rates are recomputed from summed COUNTERS with exactly
  the formulas ``sensor.aggregate.build_report`` uses, so a single-replica
  fleet is bitwise-equal to that replica's own ``SensorReport`` numbers;
* energy is priced through ``sensor.cost_model`` on the same counters;
  latency p50/p95 comes from each replica's ``serve_step`` spans;
* :class:`ReplicaHealth` distills the guard/journal stream into the router
  signals each replica's guard plane emits: quarantined lanes, sentinel trips,
  stall windows, and the windowed skip trend vs the replica's own trailing
  baseline.

Rows may arrive out of order ACROSS replicas (host clock skew, lagging
tails): the aggregator orders nothing globally — every windowed statistic is
keyed to its own replica's row sequence, so skew cannot corrupt a rollup.
Run ids must be unique fleet-wide; two replicas claiming the same run id is
a wiring bug (copied obs dir, double-started replica) and raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque
from types import SimpleNamespace
from typing import Any

import numpy as np

from repro_torch.obs.stream import ReplicaStream, discover_replica_streams

FLEET_REPORT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class ReplicaHealth:
    """Router-facing health signals for one replica (drain sticky sessions
    off a limping replica, not just a dead one)."""

    replica: str
    run: str | None = None
    steps: int = 0
    windows: int = 0              # sensor windows consumed so far
    quarantined_lanes: int = 0    # live count (journal truth, gauge fallback)
    sentinel_trips: int = 0       # cumulative containment actions
    stall_windows: int = 0        # straggler-watchdog events journaled
    torn_lines: int = 0           # stream rows lost to torn appends
    alerts: int = 0               # SLO alerts attributed to this replica
    skip_window: float = 0.0      # mac_skip over the latest sensor window
    skip_baseline: float = 0.0    # trailing-window mean (excluding latest)
    skip_trend: float = 0.0       # skip_window - skip_baseline

    @property
    def status(self) -> str:
        """Coarse placement signal: `quarantined` lanes pin dense (route
        one-shot traffic here), `limping` means latency/stream trouble
        without containment, `ok` is reuse-worthy."""
        if self.quarantined_lanes > 0:
            return "quarantined"
        if self.stall_windows > 0 or self.torn_lines > 0 or self.alerts > 0:
            return "limping"
        return "ok"

    def to_dict(self) -> dict[str, Any]:
        return dict(dataclasses.asdict(self), status=self.status)


class _ReplicaAgg:
    """Mutable per-replica aggregation state, fed row-by-row."""

    def __init__(self, replica: str, baseline_windows: int):
        self.replica = replica
        self.baseline_windows = baseline_windows
        self.runs: list[str] = []
        self.model: dict[str, Any] | None = None     # latest cumulative row
        self.site_rows: dict[tuple[str, int | None], dict[str, Any]] = {}
        self.windows = 0
        # recent windowed mac_skip values; latest is window_skips[-1]
        self.window_skips: deque[float] = deque(maxlen=baseline_windows + 1)
        self.site_window_skips: dict[str, deque[float]] = {}
        self._site_prev: dict[str, tuple[float, float]] = {}
        self._model_prev: tuple[float, float] = (0.0, 0.0)
        self.span_durs: dict[str, list[float]] = {}
        self.lane_state: dict[tuple[str, Any], str] = {}
        self.saw_guard_journal = False
        self.stall_windows = 0
        self.metrics_latest: dict[tuple[str, str], dict[str, Any]] = {}
        self.alerts = 0

    # ------------------------------------------------------------- row intake
    def add_sensor(self, row: dict[str, Any]) -> None:
        kind = row.get("kind")
        if kind == "model":
            self.model = row
            skipped = float(row.get("skipped_macs", 0.0))
            total = skipped + float(row.get("computed_macs", 0.0))
            p_skip, p_total = self._model_prev
            # cumulative counters only grow; a shrinking total means the
            # replica restarted its counters — treat the row as a fresh base
            if total < p_total:
                p_skip, p_total = 0.0, 0.0
            d_total = total - p_total
            if d_total > 0:
                # a row with NO new work (a duplicate end-of-run write) is
                # not a window — a 0/0 "skip" would fake a collapse
                self.windows += 1
                self.window_skips.append((skipped - p_skip) / d_total)
            self._model_prev = (skipped, total)
        elif kind in ("site", "layer"):
            site = row["site"]
            self.site_rows[(site, row.get("layer"))] = row
            if kind == "site":
                skipped = float(row.get("skipped_macs", 0.0))
                total = skipped + float(row.get("computed_macs", 0.0))
                p_skip, p_total = self._site_prev.get(site, (0.0, 0.0))
                if total < p_total:
                    p_skip, p_total = 0.0, 0.0
                d_total = total - p_total
                if d_total > 0:
                    self.site_window_skips.setdefault(
                        site, deque(maxlen=self.baseline_windows + 1)
                    ).append((skipped - p_skip) / d_total)
                self._site_prev[site] = (skipped, total)

    def add_span(self, row: dict[str, Any]) -> None:
        name = row.get("name")
        dur = row.get("dur_s")
        if name is None or dur is None:
            return
        self.span_durs.setdefault(name, []).append(float(dur))

    def add_journal(self, row: dict[str, Any]) -> None:
        if row.get("kind") != "decision" or \
                row.get("decision_kind") != "quarantine":
            return
        self.saw_guard_journal = True
        if row.get("field") == "state":
            self.lane_state[(row.get("site"), row.get("layer"))] = \
                row.get("after")
        elif row.get("field") == "stall_windows":
            self.stall_windows += 1

    def add_metric(self, row: dict[str, Any]) -> None:
        name = row.get("name")
        if name is None:
            return
        key = (name, json.dumps(row.get("labels", {}), sort_keys=True))
        self.metrics_latest[key] = row

    def note_run(self, run: str) -> None:
        if run not in self.runs:
            self.runs.append(run)

    # ------------------------------------------------------------- derived
    def quarantined_lanes(self) -> int:
        if self.saw_guard_journal:
            return sum(1 for s in self.lane_state.values()
                       if s == "quarantined")
        # journal-less stream (plain serve --obs-dir): trust the guard gauge
        row = self.metrics_latest.get(("guard_quarantined_lanes", "{}"))
        return int(row["value"]) if row else 0

    def skip_baseline(self) -> float:
        prior = list(self.window_skips)[:-1]
        return float(np.mean(prior)) if prior else 0.0

    def site_skip_baseline(self, site: str) -> float:
        prior = list(self.site_window_skips.get(site, ()))[:-1]
        return float(np.mean(prior)) if prior else 0.0

    def span_quantile(self, name: str, q: float) -> float:
        durs = self.span_durs.get(name)
        return float(np.quantile(durs, q)) if durs else 0.0


def _energy_from_counters(model_row: dict[str, Any]) -> dict[str, Any]:
    """Price a cumulative counter row through the shared cost model (the
    same path `sensor_energy(report)` takes — bitwise-equal on one replica)."""
    from repro_torch.sensor.cost_model import sensor_energy

    return sensor_energy(SimpleNamespace(model=model_row))


def _dense_grid_steps(site_row: dict[str, Any]) -> float:
    """Mirror of SiteSensor.dense_grid_steps, from an emitted row."""
    block_n = site_row.get("block_n", 0)
    gn = -(-site_row.get("out_features", 0) // block_n) if block_n else 0
    return float(site_row.get("total_tiles", 0) * gn)


class FleetAggregator:
    """Merge N replica streams into per-replica and fleet-level rollups."""

    def __init__(self, streams: list[ReplicaStream] | None = None, *,
                 baseline_windows: int = 3):
        self.baseline_windows = baseline_windows
        self.streams: list[ReplicaStream] = []
        self.replicas: dict[str, _ReplicaAgg] = {}
        self._run_owner: dict[str, str] = {}
        for s in streams or []:
            self.add_stream(s)

    @classmethod
    def from_fleet_dir(cls, fleet_dir: str, **kw: Any) -> "FleetAggregator":
        streams = discover_replica_streams(fleet_dir)
        if not streams:
            raise ValueError(
                f"{fleet_dir}: no replica obs dirs found (expected "
                f"subdirectories holding sensor/spans/journal/metrics JSONL)")
        return cls(streams, **kw)

    def add_stream(self, stream: ReplicaStream) -> None:
        if stream.replica in self.replicas:
            raise ValueError(f"duplicate replica id {stream.replica!r}")
        self.streams.append(stream)
        self.replicas[stream.replica] = _ReplicaAgg(
            stream.replica, self.baseline_windows)

    # ------------------------------------------------------------------ intake
    def poll(self, *, final: bool = False) -> int:
        """Drain every stream's new rows into the rollup state. Returns the
        number of rows consumed this poll."""
        n = 0
        for stream in self.streams:
            agg = self.replicas[stream.replica]
            families = stream.poll(final=final)
            for fam, rows in families.items():
                for row in rows:
                    run = (row.get("trace") or {}).get("run")
                    if run is not None:
                        owner = self._run_owner.setdefault(
                            str(run), stream.replica)
                        if owner != stream.replica:
                            raise ValueError(
                                f"run id {run!r} appears in both replica "
                                f"{owner!r} and replica {stream.replica!r} "
                                f"— run ids must be unique fleet-wide")
                        agg.note_run(str(run))
                    if fam == "sensor":
                        agg.add_sensor(row)
                    elif fam == "spans":
                        agg.add_span(row)
                    elif fam == "journal":
                        agg.add_journal(row)
                    elif fam == "metrics":
                        agg.add_metric(row)
                    n += 1
        return n

    # ----------------------------------------------------------------- health
    def health(self, replica: str) -> ReplicaHealth:
        agg = self.replicas[replica]
        stream = next(s for s in self.streams if s.replica == replica)
        model = agg.model or {}
        skip_window = agg.window_skips[-1] if agg.window_skips else 0.0
        baseline = agg.skip_baseline()
        return ReplicaHealth(
            replica=replica,
            run=agg.runs[-1] if agg.runs else None,
            steps=int(model.get("steps", 0)),
            windows=agg.windows,
            quarantined_lanes=agg.quarantined_lanes(),
            sentinel_trips=int(model.get("sentinel_trips", 0)),
            stall_windows=agg.stall_windows,
            torn_lines=stream.torn_lines,
            alerts=agg.alerts,
            skip_window=float(skip_window),
            skip_baseline=baseline,
            skip_trend=float(skip_window) - baseline,
        )

    def health_by_replica(self) -> dict[str, ReplicaHealth]:
        return {r: self.health(r) for r in sorted(self.replicas)}

    def note_alert(self, replica: str, n: int = 1) -> None:
        """SLO-watcher feedback: alerts count into the replica's health."""
        self.replicas[replica].alerts += n

    # ---------------------------------------------------------------- rollups
    def site_rollups(self) -> list[dict[str, Any]]:
        """Per-(replica, site, layer) view from each replica's latest rows."""
        out = []
        for replica in sorted(self.replicas):
            agg = self.replicas[replica]
            for (site, layer), row in sorted(
                    agg.site_rows.items(),
                    key=lambda kv: (kv[0][0], -1 if kv[0][1] is None
                                    else kv[0][1])):
                site_skips = agg.site_window_skips.get(site)
                out.append({
                    "replica": replica,
                    "site": site,
                    "layer": layer,
                    "mode": row.get("mode"),
                    "exec_path": row.get("exec_path"),
                    "steps": row.get("steps", 0),
                    "mac_skip_rate": row.get("mac_skip_rate", 0.0),
                    "tile_skip_rate": row.get("tile_skip_rate", 0.0),
                    "grid_step_skip_rate": row.get("grid_step_skip_rate", 0.0),
                    "hit_rate": row.get("hit_rate", 0.0),
                    "sentinel_trips": row.get("sentinel_trips", 0),
                    "skip_window": (site_skips[-1]
                                    if layer is None and site_skips else None),
                })
        return out

    def _replica_rollup(self, replica: str) -> dict[str, Any]:
        agg = self.replicas[replica]
        model = agg.model or {}
        health = self.health(replica)
        lat = {
            "serve_step_count": len(agg.span_durs.get("serve_step", ())),
            "serve_step_p50_s": agg.span_quantile("serve_step", 0.5),
            "serve_step_p95_s": agg.span_quantile("serve_step", 0.95),
        }
        return {
            "replica": replica,
            "run": health.run,
            "runs": list(agg.runs),
            "steps": health.steps,
            "windows": agg.windows,
            "n_sites": int(model.get("n_sites", 0)),
            "mac_skip_rate": model.get("mac_skip_rate", 0.0),
            "tile_skip_rate": model.get("tile_skip_rate", 0.0),
            "weight_byte_skip_rate": model.get("weight_byte_skip_rate", 0.0),
            "grid_step_skip_rate": model.get("grid_step_skip_rate", 0.0),
            "hit_rate": model.get("hit_rate", 0.0),
            "energy": (_energy_from_counters(model) if model else None),
            "latency": lat,
            "health": health.to_dict(),
        }

    def fleet_report(self) -> dict[str, Any]:
        """The fleet rollup: per-replica rows + counter-summed fleet rates.

        Fleet rates are recomputed from summed counters with build_report's
        exact formulas (same guards, same order), so a one-replica fleet is
        bitwise-equal to that replica's SensorReport numbers."""
        per_replica = [self._replica_rollup(r) for r in sorted(self.replicas)]
        keys = ("skipped_tiles", "computed_tiles", "skipped_macs",
                "computed_macs", "skipped_weight_bytes", "total_weight_bytes",
                "grid_steps", "sentinel_trips")
        tot = {k: 0.0 for k in keys}
        dense_grid = 0.0
        all_serve: list[float] = []
        for replica in sorted(self.replicas):
            agg = self.replicas[replica]
            model = agg.model or {}
            for k in keys:
                tot[k] += model.get(k, 0)
            dense_grid += sum(
                _dense_grid_steps(row)
                for (site, layer), row in agg.site_rows.items()
                if layer is None)
            all_serve.extend(agg.span_durs.get("serve_step", ()))
        total_tiles = tot["skipped_tiles"] + tot["computed_tiles"]
        total_macs = tot["skipped_macs"] + tot["computed_macs"]
        energies = [r["energy"] for r in per_replica if r["energy"]]
        fleet = dict(
            tot,
            steps=sum(r["steps"] for r in per_replica),
            windows=sum(r["windows"] for r in per_replica),
            total_tiles=total_tiles,
            total_macs=total_macs,
            tile_skip_rate=tot["skipped_tiles"] / max(total_tiles, 1),
            mac_skip_rate=tot["skipped_macs"] / max(total_macs, 1e-9),
            weight_byte_skip_rate=(tot["skipped_weight_bytes"]
                                   / max(tot["total_weight_bytes"], 1e-9)),
            grid_step_skip_rate=max(
                0.0, 1.0 - tot["grid_steps"] / max(dense_grid, 1e-9)),
            hit_rate=(float(np.mean([r["hit_rate"] for r in per_replica]))
                      if per_replica else 0.0),
            energy={
                "baseline_dynamic_j": math.fsum(
                    e["baseline_dynamic_j"] for e in energies),
                "measured_dynamic_j": math.fsum(
                    e["measured_dynamic_j"] for e in energies),
                "saved_dynamic_j": math.fsum(
                    e["saved_dynamic_j"] for e in energies),
            },
            # cross-mesh ICI spend (sharded replicas only; counter rows from
            # unsharded replicas carry no ici keys and contribute 0.0)
            ici_j=math.fsum(e.get("ici_j", 0.0) for e in energies),
            latency={
                "serve_step_count": len(all_serve),
                "serve_step_p50_s": (float(np.quantile(all_serve, 0.5))
                                     if all_serve else 0.0),
                "serve_step_p95_s": (float(np.quantile(all_serve, 0.95))
                                     if all_serve else 0.0),
            },
            quarantined_lanes=sum(
                r["health"]["quarantined_lanes"] for r in per_replica),
            stall_windows=sum(
                r["health"]["stall_windows"] for r in per_replica),
            torn_lines=sum(r["health"]["torn_lines"] for r in per_replica),
            alerts=sum(r["health"]["alerts"] for r in per_replica),
        )
        base = fleet["energy"]["baseline_dynamic_j"]
        fleet["energy"]["dynamic_reduction"] = \
            fleet["energy"]["saved_dynamic_j"] / max(base, 1e-30)
        return {
            "kind": "fleet_report",
            "schema_version": FLEET_REPORT_SCHEMA_VERSION,
            "n_replicas": len(per_replica),
            "per_replica": per_replica,
            "fleet": fleet,
        }

    def summary_lines(self) -> list[str]:
        rep = self.fleet_report()
        f = rep["fleet"]
        lines = [
            f"FleetReport replicas={rep['n_replicas']} "
            f"steps={f['steps']} windows={f['windows']} "
            f"mac_skip={f['mac_skip_rate']:.1%} "
            f"grid_step_skip={f['grid_step_skip_rate']:.1%} "
            f"energy_saved={f['energy']['dynamic_reduction']:.1%} "
            f"serve_p95={f['latency']['serve_step_p95_s'] * 1e3:.2f}ms "
            f"quarantined={f['quarantined_lanes']} alerts={f['alerts']}"
        ]
        for r in rep["per_replica"]:
            h = r["health"]
            lines.append(
                f"  replica {r['replica']:12s} run={str(r['run']):12s} "
                f"steps={r['steps']:4d} mac_skip={r['mac_skip_rate']:6.1%} "
                f"p95={r['latency']['serve_step_p95_s'] * 1e3:7.2f}ms "
                f"quarantined={h['quarantined_lanes']} "
                f"trips={h['sentinel_trips']} stalls={h['stall_windows']} "
                f"trend={h['skip_trend']:+.3f} [{h['status']}]"
            )
        return lines


def export_fleet_metrics(registry, agg: FleetAggregator) -> None:
    """Fleet rollup → `fleet_*` gauges on the shared registry (one labeled
    series per replica + a scope="fleet" rollup series), the Prometheus
    surface the SLO watcher's alert counters share."""
    report = agg.fleet_report()
    for r in report["per_replica"]:
        h = r["health"]
        labels = {"replica": r["replica"]}
        registry.gauge("fleet_mac_skip", **labels).set(r["mac_skip_rate"])
        registry.gauge("fleet_grid_step_skip", **labels).set(
            r["grid_step_skip_rate"])
        registry.gauge("fleet_hit_rate", **labels).set(r["hit_rate"])
        registry.gauge("fleet_steps", **labels).set(r["steps"])
        registry.gauge("fleet_windows", **labels).set(r["windows"])
        registry.gauge("fleet_serve_step_p95_seconds", **labels).set(
            r["latency"]["serve_step_p95_s"])
        registry.gauge("fleet_quarantined_lanes", **labels).set(
            h["quarantined_lanes"])
        registry.gauge("fleet_sentinel_trips", **labels).set(
            h["sentinel_trips"])
        registry.gauge("fleet_stall_windows", **labels).set(
            h["stall_windows"])
        registry.gauge("fleet_torn_lines", **labels).set(h["torn_lines"])
        registry.gauge("fleet_skip_window", **labels).set(h["skip_window"])
        registry.gauge("fleet_skip_baseline", **labels).set(
            h["skip_baseline"])
        if r["energy"]:
            registry.gauge("fleet_energy_saved_joules", **labels).set(
                r["energy"]["saved_dynamic_j"])
    f = report["fleet"]
    registry.gauge("fleet_mac_skip", scope="fleet").set(f["mac_skip_rate"])
    registry.gauge("fleet_grid_step_skip", scope="fleet").set(
        f["grid_step_skip_rate"])
    registry.gauge("fleet_steps", scope="fleet").set(f["steps"])
    registry.gauge("fleet_serve_step_p95_seconds", scope="fleet").set(
        f["latency"]["serve_step_p95_s"])
    registry.gauge("fleet_quarantined_lanes", scope="fleet").set(
        f["quarantined_lanes"])
    registry.gauge("fleet_energy_saved_joules", scope="fleet").set(
        f["energy"]["saved_dynamic_j"])
    registry.gauge("fleet_replicas", scope="fleet").set(
        report["n_replicas"])
