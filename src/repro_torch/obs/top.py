"""``python -m repro_torch.obs.top`` — live terminal view of serve-run metrics.

The port of `python -m repro.obs.top`; it reads either package's streams.

Single-replica mode tails the JSONL snapshot stream written by
`repro_torch.obs.export.write_jsonl` (e.g. `serve --obs-dir OUT` →
`OUT/metrics.jsonl`) and renders the latest snapshot as a compact table:
gauges and counters first, then histogram rows with count / mean / p50 /
p95 / p99. ``--once`` renders a single frame and exits (the CI smoke uses
it to assert the stream is renderable).

``--fleet`` takes a FLEET dir instead (replica obs subdirs, the
`launch/replicas.py` layout) and renders one column block per replica —
skip rates, serve-step latency, and the ReplicaHealth signals the router
reads — by running a `FleetAggregator` over the streams each frame.

Both modes share one snapshot loader (`load_latest_snapshot`) and exit
with a clear one-line error — not a traceback — on missing or empty
inputs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any

from repro_torch.obs.export import load_snapshots


class TopError(Exception):
    """A user-facing condition (missing/empty stream) — message, no trace."""


def load_latest_snapshot(metrics_jsonl: str) -> list[dict[str, Any]]:
    """The latest snapshot's rows from a metrics JSONL stream.

    One code path for --once, follow mode, and the fleet view's per-replica
    panes. Raises :class:`TopError` with a clear message when the file is
    missing or holds no snapshots yet."""
    if not os.path.exists(metrics_jsonl):
        raise TopError(f"{metrics_jsonl}: no such metrics stream (expected "
                       f"the metrics.jsonl a --obs-dir run writes)")
    snaps = load_snapshots(metrics_jsonl)
    if not snaps:
        raise TopError(f"{metrics_jsonl}: stream exists but holds no "
                       f"snapshots yet")
    return snaps[-1]


def _fmt_val(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.3g}"
    return f"{v:.4f}".rstrip("0").rstrip(".")


def _fmt_labels(labels: dict[str, Any]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def render_snapshot(rows: list[dict[str, Any]]) -> list[str]:
    """One terminal frame from one snapshot's rows."""
    trace = next((r.get("trace") for r in rows if r.get("trace")), None)
    header = f"repro_torch.obs.top — snap {rows[0].get('snap', '?')}" if rows else \
        "repro_torch.obs.top — empty stream"
    if trace:
        header += "  run=" + str(trace.get("run", "?"))
        if "replica" in trace:
            header += f"  replica={trace['replica']}"
        if "window" in trace:
            header += f"  window={trace['window']}"
    lines = [header, "-" * len(header)]
    scalars = [r for r in rows if r["type"] in ("counter", "gauge")]
    hists = [r for r in rows if r["type"] == "histogram"]
    for r in sorted(scalars, key=lambda r: (r["name"], str(r["labels"]))):
        name = r["name"] + _fmt_labels(r["labels"])
        lines.append(f"  {name:48s} {_fmt_val(r['value']):>12s}")
    if hists:
        lines.append("")
        lines.append(f"  {'histogram':48s} {'count':>8s} {'mean':>10s} "
                     f"{'p50':>10s} {'p95':>10s} {'p99':>10s}")
        for r in sorted(hists, key=lambda r: (r["name"], str(r["labels"]))):
            name = r["name"] + _fmt_labels(r["labels"])
            lines.append(
                f"  {name:48s} {int(r['count']):>8d} "
                f"{_fmt_val(r['mean']):>10s} {_fmt_val(r['p50']):>10s} "
                f"{_fmt_val(r['p95']):>10s} {_fmt_val(r['p99']):>10s}")
    return lines


def render_fleet(fleet_dir: str) -> list[str]:
    """One fleet frame: per-replica columns + health, from a fresh
    aggregation pass over every replica stream under `fleet_dir`."""
    from repro_torch.obs.fleet import FleetAggregator

    from repro_torch.obs.slo import load_alerts

    try:
        agg = FleetAggregator.from_fleet_dir(fleet_dir)
    except (ValueError, FileNotFoundError) as e:
        raise TopError(str(e)) from e
    agg.poll(final=True)
    # recorded SLO alerts (a fleet-level stream, not per-replica) fold back
    # into the health column they were attributed to
    for alert in load_alerts(os.path.join(fleet_dir, "alerts.jsonl")):
        if alert.get("replica") in agg.replicas:
            agg.note_alert(alert["replica"])
    report = agg.fleet_report()
    per = report["per_replica"]
    if not any(r["windows"] or r["steps"] for r in per):
        raise TopError(f"{fleet_dir}: replica dirs found but no sensor "
                       f"windows consumed yet")
    header = (f"repro_torch.obs.top — fleet {fleet_dir} "
              f"({report['n_replicas']} replicas)")
    lines = [header, "-" * len(header)]
    cols = [("replica", lambda r: r["replica"]),
            ("run", lambda r: str(r["run"])),
            ("steps", lambda r: str(r["steps"])),
            ("windows", lambda r: str(r["windows"])),
            ("mac_skip", lambda r: f"{r['mac_skip_rate']:.1%}"),
            ("grid_skip", lambda r: f"{r['grid_step_skip_rate']:.1%}"),
            ("hit", lambda r: f"{r['hit_rate']:.3f}"),
            ("p95_ms",
             lambda r: f"{r['latency']['serve_step_p95_s'] * 1e3:.2f}"),
            ("quar", lambda r: str(r["health"]["quarantined_lanes"])),
            ("trips", lambda r: str(r["health"]["sentinel_trips"])),
            ("stalls", lambda r: str(r["health"]["stall_windows"])),
            ("torn", lambda r: str(r["health"]["torn_lines"])),
            ("alerts", lambda r: str(r["health"]["alerts"])),
            ("trend", lambda r: f"{r['health']['skip_trend']:+.3f}"),
            ("status", lambda r: r["health"]["status"])]
    widths = [max(len(title), *(len(fn(r)) for r in per)) + 2
              for title, fn in cols]
    lines.append("".join(t.rjust(w) for (t, _), w in zip(cols, widths)))
    for r in per:
        lines.append("".join(fn(r).rjust(w)
                             for (_, fn), w in zip(cols, widths)))
    f = report["fleet"]
    lines.append("")
    lines.append(
        f"  fleet: mac_skip={f['mac_skip_rate']:.1%} "
        f"grid_skip={f['grid_step_skip_rate']:.1%} "
        f"energy_saved={f['energy']['dynamic_reduction']:.1%} "
        f"p95={f['latency']['serve_step_p95_s'] * 1e3:.2f}ms "
        f"quarantined={f['quarantined_lanes']} alerts={f['alerts']}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.top", description=__doc__)
    ap.add_argument("path", help="metrics snapshot stream "
                    "(OBS_DIR/metrics.jsonl), or with --fleet a fleet dir "
                    "of replica obs subdirs")
    ap.add_argument("--fleet", action="store_true",
                    help="treat PATH as a fleet dir and render per-replica "
                    "columns + health")
    ap.add_argument("--once", action="store_true",
                    help="render the latest frame once and exit")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (follow mode)")
    args = ap.parse_args(argv)

    last_snap = None
    while True:
        try:
            if args.fleet:
                frame = render_fleet(args.path)
                snap_id = object()  # fleet frames re-render every interval
            else:
                rows = load_latest_snapshot(args.path)
                frame = render_snapshot(rows)
                snap_id = rows[0].get("snap")
        except TopError as e:
            if args.once:
                print(f"repro_torch.obs.top: {e}", file=sys.stderr)
                return 1
            print(f"waiting: {e}")
        else:
            if args.once or snap_id != last_snap:
                if not args.once:
                    sys.stdout.write("\x1b[2J\x1b[H")
                print("\n".join(frame))
                last_snap = snap_id
        if args.once:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
