"""The port's fleet plane (`repro_torch.obs.{stream,fleet,slo,top}`) and its
N-replica harness (`repro_torch.launch.replicas`) against the reference's,
on the CPU.

The reference's own cases (`tests/test_fleet.py`, on its synthetic
streams) run on the port; the single-replica rollup is held bitwise to the
port's own SensorReport and cost model. Then the reduced qwen3 fleet: the
reference's harness (its replicas' engines at impl="pallas", the
compiled-XLA tier here) and the port's, given the reference's weights, with
`--inject poison-sim` on r1 — journals and sensor rows equal row for row per
replica, the same alerts, naming r1 alone; both packages' aggregators and
SLO watchers fed the same obs dirs make the same fleet report (energy
checked against the port's cost model), alerts and `fleet_*` text; the
fleet without injection raises no alert; `obs.top --fleet` renders it.
"""

import json
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.control import load_journal as jload_journal
from repro.models import init_params as jinit_params
from repro.obs import events as jevents
from repro.obs import export as jexport
from repro.obs import fleet as jfleet
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro_torch.configs import ARCHS
from repro_torch.launch import replicas as trep
from repro_torch.models import params_from_numpy
from repro_torch.obs import events, export, fleet, metrics, slo
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.fleet import FleetAggregator, ReplicaHealth
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SLOConfig, SLOWatcher, load_alerts
from repro_torch.obs.stream import (
    ReplicaStream,
    TailCursor,
    discover_replica_streams,
    tail_jsonl,
)
from test_fleet import (
    _append,
    _mk_replica_dir,
    _model_row,
    _quarantine_row,
    _site_row,
)


@pytest.fixture(autouse=True)
def _clean_ids():
    for ev in (events, jevents):
        ev.clear_ids()
    yield
    for ev in (events, jevents):
        ev.clear_ids()


# ------------------------------------------------------------------- tailing

def test_tail_jsonl_holds_back_partial_line(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text(json.dumps({"a": 1}) + "\n" + '{"par')
    cur = TailCursor()
    assert tail_jsonl(str(p), cur) == [{"a": 1}]
    assert cur.rows == 1 and cur.torn == 0
    with open(p, "a") as f:
        f.write('tial": 2}\n')
    assert tail_jsonl(str(p), cur) == [{"partial": 2}]
    assert cur.rows == 2 and cur.torn == 0
    assert tail_jsonl(str(p), cur) == []


def test_tail_jsonl_final_torn_line_forgiven_and_counted(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text(json.dumps({"a": 1}) + "\n" + '{"torn')
    cur = TailCursor()
    assert tail_jsonl(str(p), cur, final=True) == [{"a": 1}]
    assert cur.torn == 1
    p2 = tmp_path / "s2.jsonl"
    p2.write_text(json.dumps({"a": 1}) + "\n" + '{"bad\n')
    cur2 = TailCursor()
    assert tail_jsonl(str(p2), cur2, final=True) == [{"a": 1}]
    assert cur2.torn == 1


def test_tail_jsonl_midfile_corruption_raises(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text('{"bad\n' + json.dumps({"a": 1}) + "\n")
    with pytest.raises(ValueError, match="corruption"):
        tail_jsonl(str(p), TailCursor(), final=True)
    with pytest.raises(ValueError, match="corruption"):
        tail_jsonl(str(p), TailCursor())


def test_replica_stream_rejects_conflicting_replica_stamp(tmp_path):
    d = _mk_replica_dir(tmp_path, "r0")
    _append(d / "sensor.jsonl", [_model_row(1, 1, replica="r9")])
    stream = ReplicaStream(str(d))
    assert stream.replica == "r0"  # replica- prefix stripped from basename
    with pytest.raises(ValueError, match="replica"):
        stream.poll()


def test_discover_replica_streams(tmp_path):
    for name in ("r1", "r0"):
        d = _mk_replica_dir(tmp_path, name)
        _append(d / "sensor.jsonl", [_model_row(1, 1)])
    (tmp_path / "not-a-replica").mkdir()
    (tmp_path / "fleet_report.json").write_text("{}")
    streams = discover_replica_streams(str(tmp_path))
    assert [s.replica for s in streams] == ["r0", "r1"]


# --------------------------------------------------------------- aggregation

def test_duplicate_run_ids_across_replicas_rejected(tmp_path):
    for name in ("r0", "r1"):
        d = _mk_replica_dir(tmp_path, name)
        _append(d / "sensor.jsonl",
                [_model_row(1, 1, run="same-run", replica=name)])
    agg = FleetAggregator.from_fleet_dir(str(tmp_path))
    with pytest.raises(ValueError, match="unique fleet-wide"):
        agg.poll()


def test_torn_tail_in_one_replica_tolerated_and_counted(tmp_path):
    d0 = _mk_replica_dir(tmp_path, "r0")
    _append(d0 / "sensor.jsonl",
            [_model_row(50, 50, run="run-0", replica="r0")])
    d1 = _mk_replica_dir(tmp_path, "r1")
    _append(d1 / "sensor.jsonl",
            [_model_row(40, 60, run="run-1", replica="r1")])
    with open(d1 / "sensor.jsonl", "a") as f:
        f.write('{"died mid-app')
    agg = FleetAggregator.from_fleet_dir(str(tmp_path))
    agg.poll(final=True)
    assert agg.health("r0").torn_lines == 0
    assert agg.health("r1").torn_lines == 1
    rep = agg.fleet_report()
    assert rep["n_replicas"] == 2 and rep["fleet"]["torn_lines"] == 1
    assert {r["replica"]: r["run"] for r in rep["per_replica"]} == \
        {"r0": "run-0", "r1": "run-1"}


def test_out_of_order_polls_equivalent_to_one_shot(tmp_path):
    """Cross-replica arrival order must not change the rollup: replica B
    fully lands before replica A in one aggregation, interleaved window by
    window in the other."""
    windows = [(10, 90), (20, 80), (35, 65), (50, 50)]

    def one_window(d, name, cum, idx):
        s, c = windows[idx]
        cum[0] += s
        cum[1] += c
        _append(d / "sensor.jsonl", [
            _model_row(cum[0], cum[1], steps=idx + 1, run=f"run-{name}",
                       replica=name),
            _site_row("site0", cum[0], cum[1], run=f"run-{name}",
                      replica=name),
        ])

    one_shot = tmp_path / "one"
    one_shot.mkdir()
    for name in ("ra", "rb"):
        d, cum = _mk_replica_dir(one_shot, name), [0.0, 0.0]
        for i in range(len(windows)):
            one_window(d, name, cum, i)
    agg1 = FleetAggregator.from_fleet_dir(str(one_shot))
    agg1.poll(final=True)

    skewed = tmp_path / "skewed"
    skewed.mkdir()
    da, db = _mk_replica_dir(skewed, "ra"), _mk_replica_dir(skewed, "rb")
    agg2 = FleetAggregator([ReplicaStream(str(da)), ReplicaStream(str(db))])
    cum = {"ra": [0.0, 0.0], "rb": [0.0, 0.0]}
    for i in range(len(windows)):
        one_window(db, "rb", cum["rb"], i)
    agg2.poll()
    for i in range(len(windows)):
        one_window(da, "ra", cum["ra"], i)
        agg2.poll()
    agg2.poll(final=True)
    assert json.dumps(agg1.fleet_report(), sort_keys=True) == \
        json.dumps(agg2.fleet_report(), sort_keys=True)


def test_single_replica_rollup_bitwise_equals_sensor_report(tmp_path):
    """The port's measured decode through the port's aggregator: the rollup
    carries the SensorReport's numbers, and the fleet rates recomputed from
    summed counters are bitwise equal to them; energy is the port's cost
    model's, bitwise."""
    from repro_torch.sensor.cost_model import sensor_energy
    from repro_torch.sensor.runner import run_measured_decode

    md = run_measured_decode("qwen3-32b", steps=8, batch=2, correlation=0.9,
                             device="cpu")
    report = md.report
    d = _mk_replica_dir(tmp_path, "solo")
    with events.context(run="run-solo", replica="solo"):
        report.write_jsonl(str(d / "sensor.jsonl"))
    agg = FleetAggregator.from_fleet_dir(str(tmp_path))
    agg.poll(final=True)
    fleet_rep = agg.fleet_report()
    assert fleet_rep["n_replicas"] == 1
    solo, f = fleet_rep["per_replica"][0], fleet_rep["fleet"]
    keys = ("mac_skip_rate", "tile_skip_rate", "weight_byte_skip_rate",
            "grid_step_skip_rate", "hit_rate")
    for key in keys:
        assert solo[key] == report.model[key], key
        assert f[key] == report.model[key], key
    assert report.model["mac_skip_rate"] > 0.0
    energy = sensor_energy(report)
    for key in ("baseline_dynamic_j", "measured_dynamic_j",
                "saved_dynamic_j", "dynamic_reduction"):
        assert solo["energy"][key] == energy[key], key
        assert f["energy"][key] == energy[key], key


# -------------------------------------------------------------------- health

def test_replica_health_from_journal_stream(tmp_path):
    d = _mk_replica_dir(tmp_path, "r0")
    _append(d / "sensor.jsonl",
            [_model_row(50, 50, steps=6, trips=2, run="run-0",
                        replica="r0")])
    _append(d / "journal.jsonl", [
        _quarantine_row("mlp_in", 0, "active", "quarantined",
                        run="run-0", replica="r0"),
        _quarantine_row("attn_qkv", 1, "active", "quarantined",
                        run="run-0", replica="r0"),
        _quarantine_row("attn_qkv", 1, "quarantined", "probation",
                        run="run-0", replica="r0"),
        {"kind": "decision", "decision_kind": "quarantine",
         "field": "stall_windows", "site": "", "layer": None,
         "before": 0, "after": 1, "step": 18, "schema_version": 4,
         "trace": {"run": "run-0", "replica": "r0"}},
    ])
    agg = FleetAggregator.from_fleet_dir(str(tmp_path))
    agg.poll(final=True)
    h = agg.health("r0")
    assert isinstance(h, ReplicaHealth)
    assert h.quarantined_lanes == 1       # attn_qkv@1 moved on to probation
    assert h.sentinel_trips == 2
    assert h.stall_windows == 1
    assert h.run == "run-0"
    assert h.status == "quarantined"
    assert h.to_dict()["status"] == "quarantined"


def test_replica_health_quarantine_gauge_fallback(tmp_path):
    d = _mk_replica_dir(tmp_path, "r0")
    _append(d / "sensor.jsonl", [_model_row(10, 90, run="run-0",
                                            replica="r0")])
    _append(d / "metrics.jsonl", [
        {"name": "guard_quarantined_lanes", "labels": {}, "type": "gauge",
         "value": 3.0, "snap": 1, "trace": {"run": "run-0",
                                            "replica": "r0"}}])
    agg = FleetAggregator.from_fleet_dir(str(tmp_path))
    agg.poll(final=True)
    assert agg.health("r0").quarantined_lanes == 3


# ----------------------------------------------------------------- SLO watch

def _fleet_two(tmp_path):
    d0 = _mk_replica_dir(tmp_path, "r0")
    d1 = _mk_replica_dir(tmp_path, "r1")
    agg = FleetAggregator([ReplicaStream(str(d0)), ReplicaStream(str(d1))])
    return d0, d1, agg


def test_slo_skip_collapse_attributes_injected_replica(tmp_path):
    d0, d1, agg = _fleet_two(tmp_path)
    registry = MetricsRegistry()
    alerts_path = tmp_path / "alerts.jsonl"
    watcher = SLOWatcher(
        agg, SLOConfig(collapse_frac=0.6, collapse_consecutive=2),
        registry=registry, alerts_path=str(alerts_path))
    r0_windows = [(50, 50)] * 8
    r1_windows = [(50, 50)] * 4 + [(0, 100)] * 4
    cum = {"r0": [0.0, 0.0], "r1": [0.0, 0.0]}
    for i in range(8):
        for name, d, (s, c) in (("r0", d0, r0_windows[i]),
                                ("r1", d1, r1_windows[i])):
            cum[name][0] += s
            cum[name][1] += c
            _append(d / "sensor.jsonl",
                    [_model_row(cum[name][0], cum[name][1], steps=i + 1,
                                run=f"run-{name}", replica=name)])
        agg.poll()
        watcher.evaluate()
    assert [(a["alert_kind"], a["replica"], a["site"])
            for a in watcher.alerts] == [("skip_collapse", "r1", "")]
    assert agg.health("r0").alerts == 0 and agg.health("r1").alerts == 1
    a = watcher.alerts[0]
    assert a["value"] < 0.6 * a["baseline"] and a["run"] == "run-r1"
    assert registry.counter("fleet_alerts_total", alert="skip_collapse",
                            replica="r1").value == 1.0
    assert load_alerts(str(alerts_path)) == watcher.alerts
    with open(alerts_path, "a") as f:
        f.write('{"torn')
    assert load_alerts(str(alerts_path)) == watcher.alerts


def test_slo_collapse_ignores_warmup_and_rising_skip(tmp_path):
    d0, _, agg = _fleet_two(tmp_path)
    watcher = SLOWatcher(agg, SLOConfig())
    cum = [0.0, 0.0]
    for i, (s, c) in enumerate([(0, 100), (1, 99), (10, 90), (30, 70),
                                (50, 50), (50, 50)]):
        cum[0] += s
        cum[1] += c
        _append(d0 / "sensor.jsonl",
                [_model_row(cum[0], cum[1], steps=i + 1, run="run-r0",
                            replica="r0")])
        agg.poll()
        watcher.evaluate()
    assert watcher.alerts == []


def test_slo_per_site_collapse_names_site(tmp_path):
    d0, _, agg = _fleet_two(tmp_path)
    watcher = SLOWatcher(
        agg, SLOConfig(collapse_frac=0.6, collapse_consecutive=2))
    model_cum, site_cum = [0.0, 0.0], [0.0, 0.0]
    for i in range(8):
        model_cum[0] += 50
        model_cum[1] += 50
        s, c = (40, 60) if i < 4 else (0, 100)
        site_cum[0] += s
        site_cum[1] += c
        _append(d0 / "sensor.jsonl", [
            _model_row(model_cum[0], model_cum[1], steps=i + 1,
                       run="run-r0", replica="r0"),
            _site_row("attn_qkv", site_cum[0], site_cum[1],
                      run="run-r0", replica="r0"),
        ])
        agg.poll()
        watcher.evaluate()
    assert [(a["alert_kind"], a["replica"], a["site"])
            for a in watcher.alerts] == [("skip_collapse", "r0",
                                          "attn_qkv")]


def test_slo_quarantine_spike(tmp_path):
    d0, d1, agg = _fleet_two(tmp_path)
    watcher = SLOWatcher(agg, SLOConfig())
    _append(d0 / "journal.jsonl",
            [_quarantine_row("mlp_in", 0, "active", "quarantined",
                             run="run-r0", replica="r0")])
    agg.poll()
    assert [(a["alert_kind"], a["replica"]) for a in watcher.evaluate()] == \
        [("quarantine_spike", "r0")]
    assert watcher.evaluate() == []
    _append(d0 / "journal.jsonl", [
        _quarantine_row("mlp_in", 0, "quarantined", "active",
                        run="run-r0", replica="r0")])
    agg.poll()
    assert watcher.evaluate() == []
    _append(d0 / "journal.jsonl", [
        _quarantine_row("attn_qkv", 1, "active", "quarantined",
                        run="run-r0", replica="r0")])
    agg.poll()
    assert [a["alert_kind"] for a in watcher.evaluate()] == \
        ["quarantine_spike"]


def test_slo_p95_burn(tmp_path):
    d0, d1, agg = _fleet_two(tmp_path)
    watcher = SLOWatcher(agg, SLOConfig(p95_target_s=0.010, p95_min_count=5))
    spans = [{"name": "serve_step", "span_id": i + 1, "parent_id": 0,
              "dur_s": 0.002, "trace": {"run": "run-r0", "replica": "r0"}}
             for i in range(6)]
    _append(d0 / "spans.jsonl", spans)
    agg.poll()
    assert watcher.evaluate() == []
    slow = [{"name": "serve_step", "span_id": 10 + i, "parent_id": 0,
             "dur_s": 0.050, "trace": {"run": "run-r0", "replica": "r0"}}
            for i in range(10)]
    _append(d0 / "spans.jsonl", slow)
    agg.poll()
    alerts = watcher.evaluate()
    assert [(a["alert_kind"], a["replica"]) for a in alerts] == \
        [("p95_burn", "r0")]
    assert alerts[0]["value"] > 0.010
    assert watcher.evaluate() == []


# ---------------------------------------------------------- exports and view

def test_export_fleet_metrics_series(tmp_path):
    d0, d1, agg = _fleet_two(tmp_path)
    _append(d0 / "sensor.jsonl",
            [_model_row(50, 50, steps=4, run="run-r0", replica="r0")])
    _append(d1 / "sensor.jsonl",
            [_model_row(25, 75, steps=4, run="run-r1", replica="r1")])
    agg.poll(final=True)
    reg = MetricsRegistry()
    fleet.export_fleet_metrics(reg, agg)
    p = tmp_path / "fleet.prom"
    export.write_prometheus(str(p), reg)
    parsed = export.parse_prometheus(p.read_text())
    assert parsed["fleet_mac_skip"]['{replica="r0"}'] == pytest.approx(0.5)
    assert parsed["fleet_mac_skip"]['{replica="r1"}'] == pytest.approx(0.25)
    assert parsed["fleet_mac_skip"]['{scope="fleet"}'] == \
        pytest.approx(75 / 200)
    assert parsed["fleet_replicas"]['{scope="fleet"}'] == 2.0


def test_top_fleet_view_and_clear_errors(tmp_path, capsys):
    from repro_torch.obs.top import main as top_main

    assert top_main([str(tmp_path / "nope" / "metrics.jsonl"), "--once"]) == 1
    assert "no such metrics stream" in capsys.readouterr().err
    assert top_main([str(tmp_path), "--fleet", "--once"]) == 1
    assert "no replica obs dirs" in capsys.readouterr().err
    for name, skipped in (("r0", 50), ("r1", 25)):
        d = _mk_replica_dir(tmp_path, name)
        _append(d / "sensor.jsonl",
                [_model_row(skipped, 100 - skipped, steps=4,
                            run=f"run-{name}", replica=name)])
    assert top_main([str(tmp_path), "--fleet", "--once"]) == 0
    out = capsys.readouterr().out
    assert "r0" in out and "r1" in out and "status" in out
    assert "run-r0" in out and "run-r1" in out


# ----------------------------------------------- the fleet, both packages

FLEET = ["--arch", "qwen3-32b", "--reduced", "--replicas", "2",
         "--requests", "4", "--max-new", "16", "--control-every", "4"]
INJECT = ["--inject", "poison-sim:at_step=24"]


def _port_fleet(out, argv, params):
    obs_trace.drain_spans()
    return trep.run(ARCHS["qwen3-32b"].reduced(),
                    trep.build_parser().parse_args(
                        argv + ["--out", str(out), "--device", "cpu"]),
                    params=params)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The injected reduced-qwen3 fleet through the reference's harness
    (engines at impl="pallas") and the port's, on the reference's weights;
    and the port's fleet without injection."""
    from repro.launch import replicas as jrep

    root = tmp_path_factory.mktemp("fleets")
    mp = pytest.MonkeyPatch()
    build = jrep.build_reuse_engine
    mp.setattr(jrep, "build_reuse_engine",
               lambda cfg, *, impl="jnp", policy=None: build(
                   cfg, impl="pallas", policy=policy))
    mp.setattr(sys, "argv", ["replicas", *FLEET, *INJECT, "--out",
                             str(root / "ref")])
    jtrace.drain_spans()
    try:
        jrep.main()
    finally:
        jtrace.disable()
        jtrace.drain_spans()
        mp.undo()
    tree = jax.tree.map(np.asarray, jinit_params(
        JARCHS["qwen3-32b"].reduced(), jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, ARCHS["qwen3-32b"].reduced(), "cpu")
    port = _port_fleet(root / "port", FLEET + INJECT, params)
    clean = _port_fleet(root / "clean", FLEET, params)
    return root, port, clean


def _strip(rows, drop=("ts", "trace")):
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def _jsonl(path):
    return [json.loads(ln) for ln in open(path)]


def test_replicas_run_matches_reference(fleets):
    """Per replica, the port's journal and sensor rows equal the
    reference's row for row (but for the wall-clock `ts` and the random run
    ids), and both harnesses raise the same alerts: r1's quarantine spike,
    nothing on r0."""
    root, port, _ = fleets
    for r in ("r0", "r1"):
        for fam, load in (("journal", jload_journal), ("sensor", _jsonl)):
            want = _strip(load(str(root / "ref" / f"replica-{r}" /
                                   f"{fam}.jsonl")))
            got = _strip(load(str(root / "port" / f"replica-{r}" /
                                  f"{fam}.jsonl")))
            assert got == want, (r, fam)
            assert len(got) > 20
    ref_alerts = _strip(jslo.load_alerts(str(root / "ref" / "alerts.jsonl")),
                        drop=("run",))
    port_alerts = _strip(port["alerts"], drop=("run",))
    assert port_alerts == ref_alerts
    assert {a["replica"] for a in port_alerts} == {"r1"}
    assert [a["alert_kind"] for a in port_alerts] == ["quarantine_spike"]
    with open(root / "port" / "fleet_report.json") as f:
        rep = json.load(f)
    assert rep["n_replicas"] == 2
    health = {r["replica"]: r["health"] for r in rep["per_replica"]}
    assert health["r0"]["status"] == "ok" and health["r0"]["alerts"] == 0
    assert health["r1"]["sentinel_trips"] == 1 and health["r1"]["alerts"] == 1


def _aggregate(pkg, fleet_dir):
    """Both packages' fleet plane over the same replica dirs, polled once
    at the end: (fleet report, alerts, fleet Prometheus lines)."""
    fl, sl, mt, ex = pkg
    agg = fl.FleetAggregator.from_fleet_dir(str(fleet_dir))
    reg = mt.MetricsRegistry()
    watcher = sl.SLOWatcher(agg, sl.SLOConfig(), registry=reg)
    agg.poll(final=True)
    watcher.evaluate()
    fl.export_fleet_metrics(reg, agg)
    return agg.fleet_report(), watcher.alerts, ex.prometheus_lines(reg)


def _without_energy(report):
    report = json.loads(json.dumps(report))
    energy = [r.pop("energy") for r in report["per_replica"]]
    energy.append(report["fleet"].pop("energy"))
    return report, energy


def test_aggregators_on_the_same_streams_match_reference(fleets, tmp_path):
    """The port's obs dirs through both packages' aggregator, watcher and
    exporter: equal fleet reports but for energy, which is the port's cost
    model on each replica's counters; equal alerts; equal `fleet_*` text
    line for line."""
    from repro_torch.sensor.cost_model import sensor_energy

    root = fleets[0]
    for fleet_dir in (root / "port", root / "clean"):
        # the aggregators read replica dirs only: no fleet-level files
        d = tmp_path / fleet_dir.name
        for sub in ("replica-r0", "replica-r1"):
            shutil.copytree(fleet_dir / sub, d / sub)
        port = _aggregate((fleet, slo, metrics, export), d)
        ref = _aggregate((jfleet, jslo, jmetrics, jexport), d)
        (prep, penergy), (rrep, _) = (_without_energy(port[0]),
                                      _without_energy(ref[0]))
        assert prep == rrep
        assert port[1] == ref[1]
        assert port[2] == ref[2]
        for r, e in zip(port[0]["per_replica"], penergy):
            model = [row for row in _jsonl(d / f"replica-{r['replica']}" /
                                           "sensor.jsonl")
                     if row["kind"] == "model"][-1]
            want = sensor_energy(SimpleNamespace(model=model))
            assert e == want
        assert penergy[-1]["saved_dynamic_j"] == pytest.approx(
            sum(e["saved_dynamic_j"] for e in penergy[:-1]), rel=1e-12)


def test_clean_fleet_raises_no_alert(fleets):
    _, _, clean = fleets
    assert clean["alerts"] == []
    rep = clean["report"]
    assert rep["n_replicas"] == 2 and rep["fleet"]["alerts"] == 0
    assert all(r["health"]["status"] == "ok" for r in rep["per_replica"])
    assert all(r["health"]["sentinel_trips"] == 0
               for r in rep["per_replica"])


def test_top_renders_the_fleet(fleets, capsys):
    from repro_torch.obs.top import main as top_main

    assert top_main([str(fleets[0] / "port"), "--fleet", "--once"]) == 0
    out = capsys.readouterr().out
    assert "(2 replicas)" in out and "quarantined" in out
    lines = {ln.split()[0]: ln for ln in out.splitlines()
             if ln.strip().startswith(("r0 ", "r1 "))}
    assert lines["r1"].split()[-1] == "quarantined"
    assert lines["r0"].split()[-1] == "ok"


def test_replicas_flags_fail_loudly(tmp_path, capsys, monkeypatch):
    """`--inject-replica` without `--inject` raises the reference's message,
    an index out of range raises, and the default device needs a card."""
    from repro.launch import replicas as jrep

    cfg = ARCHS["qwen3-32b"].reduced()
    argv = FLEET + ["--out", str(tmp_path), "--inject-replica", "0"]
    with pytest.raises(ValueError) as e:
        trep.run(cfg, trep.build_parser().parse_args(argv))
    monkeypatch.setattr(sys, "argv", ["replicas", *argv])
    with pytest.raises(SystemExit):
        jrep.main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert str(e.value) == ref_err.split("error: ")[1] == \
        "--inject-replica requires --inject"
    with pytest.raises(ValueError, match="out of range"):
        trep.run(cfg, trep.build_parser().parse_args(
            argv[:-2] + INJECT + ["--inject-replica", "5"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trep.main(FLEET + ["--out", str(tmp_path)])
    assert not os.listdir(tmp_path)  # nothing ran
