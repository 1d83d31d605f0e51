"""The port's observability plane (`repro_torch.obs`: spans, metrics and
export, the measured latency table and its pricing) against the
reference's (`repro.obs`), on the CPU.

The reference's own cases (`tests/test_obs.py`, all but the journal and
restore ones) run on the port; then the same inputs go through both
packages: the same span rows, sensor-v6 rows and journal rows make equal
Prometheus text and snapshots, line for line; a latency table saved by
either package loads in the other with equal rows and provenance; the
probe draws the reference's inputs; one fixed latency table prices
`solve_site` and a reduced-qwen3 `serve --control-every --latency-table`
to equal decisions in both packages (the reference serve's engine at
impl="pallas", the compiled-XLA tier here, and its weights carried over, so
the journals are equal row for row); and the fit CLI's `--latency-table`
writes the reference's table.
"""

import json
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.control import load_journal as jload_journal
from repro.core import ReuseEngine as JEngine
from repro.models import init_params as jinit_params
from repro.obs import events as jevents
from repro.obs import export as jexport
from repro.obs import latency as jlatency
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.tune.harvest import FitConfig as JFit
from repro.tune.harvest import solve_site as jsolve_site
from repro.tune.trace import SiteTraceRecord as JRecord
from repro_torch import control as tctl
from repro_torch.configs import ARCHS
from repro_torch.core.engine import ReuseEngine
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import params_from_numpy
from repro_torch.obs import events, export, metrics
from repro_torch.obs import latency as tlatency
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import (
    load_snapshots,
    parse_prometheus,
    write_jsonl,
    write_prometheus,
)
from repro_torch.obs.latency import (
    BASIC_PATH,
    LatencyTable,
    LatencyTableError,
    build_from_spans,
    load_latency_table,
    probe_latency_table,
    table_provenance,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.tune.harvest import FitConfig, measured_latency_note, solve_site
from repro_torch.tune.trace import SiteTraceRecord

CARD = {"backend": "cuda", "interpret": False}


def _reset_obs():
    for ev, tr in ((events, obs_trace), (jevents, jtrace)):
        ev.clear_ids()
        tr.disable()
        tr.drain_spans()
        tr._STATE["max_spans"] = 262_144


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Obs state is module-global (single-threaded host loop); isolate it."""
    _reset_obs()
    yield
    _reset_obs()


# ------------------------------------------------------------------ tracing

def test_span_nesting_parent_ids_and_tags():
    obs_trace.enable()
    with obs_trace.span("outer", phase="serve") as outer:
        with obs_trace.span("inner") as inner:
            inner.tag(tokens=3)
        assert inner.parent_id == outer.span_id
    rows = obs_trace.spans()
    assert [r["name"] for r in rows] == ["inner", "outer"]  # close order
    by_name = {r["name"]: r for r in rows}
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["outer"]["parent_id"] == 0
    assert by_name["inner"]["tokens"] == 3
    assert by_name["outer"]["phase"] == "serve"
    assert all(r["dur_s"] >= 0.0 for r in rows)


def test_span_records_correlation_ids():
    obs_trace.enable()
    with events.context(run="r1", request=7):
        with obs_trace.span("prefill"):
            pass
    with obs_trace.span("bare"):
        pass
    rows = {r["name"]: r for r in obs_trace.spans()}
    assert rows["prefill"]["trace"] == {"run": "r1", "request": 7}
    assert "trace" not in rows["bare"]


def test_span_rows_match_reference():
    """The same nested program of spans, tags, ids and syncs makes the same
    rows in both packages, but for the measured durations; a sync of a
    host value or a CPU tensor returns it and waits for nothing."""
    def program(ev, tr, value):
        tr.enable()
        tr._STATE["next_id"] = 1  # span ids count per process
        with ev.context(run="R", window=2):
            with tr.span("serve_step", active=2) as sp:
                with tr.span("prefill", slot=1, prompt_len=4) as inner:
                    assert inner.sync(value) is value
                sp.tag(tokens=2)
                assert sp.sync(value) is value
        with tr.span("bare", site="mlp_in", exec_path="kernel"):
            pass
        return [{k: v for k, v in r.items() if k != "dur_s"}
                for r in tr.drain_spans()]

    ref = program(jevents, jtrace, jax.numpy.ones(3))
    port = program(events, obs_trace, torch.ones(3))
    assert port == ref
    assert program(events, obs_trace, np.ones(3)) == ref


def test_disabled_span_is_shared_noop_and_records_nothing():
    assert not obs_trace.is_enabled()
    a = obs_trace.span("serve_step", exec_path="kernel")
    b = obs_trace.span("another")
    assert a is b  # ONE shared no-op object: no per-call allocation
    with a as sp:
        val = object()
        assert sp.sync(val) is val
        assert sp.tag(k=1) is sp
    assert obs_trace.spans() == []


def test_disabled_span_overhead_is_negligible():
    """A serve step is milliseconds; lock an absolute per-call bound with
    ~30x headroom over the measured dict-lookup cost."""
    n = 2000
    t0 = obs_trace.now()
    for _ in range(n):
        with obs_trace.span("serve_step"):
            pass
    per_call = (obs_trace.now() - t0) / n
    assert per_call < 10e-6, f"disabled span cost {per_call * 1e6:.2f}us/call"


def test_span_buffer_cap_counts_drops():
    obs_trace.enable(max_spans=2)
    for i in range(4):
        with obs_trace.span(f"s{i}"):
            pass
    assert len(obs_trace.spans()) == 2
    assert obs_trace._STATE["dropped"] == 2
    drained = obs_trace.drain_spans()
    assert [r["name"] for r in drained] == ["s0", "s1"]
    assert obs_trace.spans() == [] and obs_trace._STATE["dropped"] == 0


def test_write_spans_jsonl_round_trip(tmp_path):
    obs_trace.enable()
    with obs_trace.span("a", site="mlp_in"):
        pass
    p = tmp_path / "spans.jsonl"
    assert obs_trace.write_spans_jsonl(str(p)) == 1
    assert obs_trace.spans() == []  # drained
    row = json.loads(p.read_text().strip())
    assert row["name"] == "a" and row["site"] == "mlp_in"


def test_profile_window_writes_a_chrome_trace_with_the_spans(tmp_path):
    obs_trace.enable()
    assert obs_trace.start_profile(str(tmp_path / "prof"))
    with obs_trace.span("serve_step"):
        torch.ones(64) @ torch.ones(64)
    path = obs_trace.stop_profile()
    assert path == str(tmp_path / "prof" / "trace.json")
    doc = json.loads(open(path).read())
    assert any(e.get("name") == "serve_step" for e in doc["traceEvents"])
    assert obs_trace.stop_profile() is None  # no window open


# ----------------------------------------------------------- correlation ids

def test_stamp_is_identity_with_no_ids():
    row = {"kind": "site", "site": "s"}
    assert events.stamp(row) is row


def test_context_nesting_restores_outer_ids():
    events.set_ids(run="R")
    with events.context(window=3):
        assert events.current_ids() == {"run": "R", "window": 3}
        with events.context(window=4, request=9):
            assert events.current_ids() == {
                "run": "R", "window": 4, "request": 9}
        assert events.current_ids() == {"run": "R", "window": 3}
    assert events.current_ids() == {"run": "R"}
    assert events.stamp({"x": 1}) == {"x": 1, "trace": {"run": "R"}}
    events.clear_ids()
    assert events.current_ids() == {}


# ----------------------------------------------------------- metrics/export

def test_registry_keying_and_histogram_percentiles():
    reg = MetricsRegistry()
    assert reg.counter("c", site="a") is reg.counter("c", site="a")
    assert reg.counter("c", site="a") is not reg.counter("c", site="b")
    h = reg.histogram("lat")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100 and h.mean == pytest.approx(50.5)
    assert h.percentile(0.5) == pytest.approx(50.5)
    assert h.percentile(0.95) == pytest.approx(95.05)
    s = h.summary()
    assert s["min"] == 1.0 and s["max"] == 100.0 and "p99" in s


def test_prometheus_round_trip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("control_decisions", kind="retune").inc(3)
    reg.gauge("reuse_site_hit_rate", site="mlp_in").set(0.875)
    h = reg.histogram("span_serve_step_seconds")
    for v in (0.001, 0.002, 0.003):
        h.observe(v)
    p = tmp_path / "metrics.prom"
    assert write_prometheus(str(p), reg) > 0
    parsed = parse_prometheus(p.read_text())
    assert parsed["control_decisions"]['{kind="retune"}'] == 3.0
    assert parsed["reuse_site_hit_rate"]['{site="mlp_in"}'] == \
        pytest.approx(0.875)
    assert parsed["span_serve_step_seconds_count"][""] == 3.0
    assert parsed["span_serve_step_seconds_sum"][""] == pytest.approx(0.006)
    assert parsed["span_serve_step_seconds"]['{quantile="0.5"}'] == \
        pytest.approx(0.002)


HOSTILE = {"quote": 'va"lue', "backslash": "back\\slash",
           "newline": "line1\nline2", "brace": "cl}osing", "comma": "a,b=c",
           "all": 'x"\\\n}y'}


def test_prometheus_round_trip_hostile_labels(tmp_path):
    """Exposition-format escaping: each hostile label value round-trips,
    and the port's textfile is the reference's, byte for byte."""
    texts = {}
    for pkg, (mt, ex) in {"port": (metrics, export),
                          "ref": (jmetrics, jexport)}.items():
        reg = mt.MetricsRegistry()
        for i, (key, val) in enumerate(sorted(HOSTILE.items())):
            reg.gauge("hostile_gauge", **{key: val}).set(float(i))
        p = tmp_path / f"{pkg}.prom"
        ex.write_prometheus(str(p), reg)
        texts[pkg] = p.read_text()
    assert texts["port"] == texts["ref"]
    parsed = parse_prometheus(texts["port"])
    for i, (key, val) in enumerate(sorted(HOSTILE.items())):
        label_str = export._prom_labels({key: val})
        assert parsed["hostile_gauge"][label_str] == float(i)
        assert export.parse_labels(label_str[1:-1]) == {key: val}


def test_parse_prometheus_rejects_untyped_samples():
    with pytest.raises(ValueError, match="TYPE"):
        parse_prometheus("orphan_metric 1.0\n")
    with pytest.raises(ValueError, match="not a prometheus sample"):
        parse_prometheus("# TYPE x gauge\nx = what\n")


def test_jsonl_snapshots_group_and_stamp(tmp_path):
    reg = MetricsRegistry()
    reg.gauge("g").set(1.0)
    p = tmp_path / "metrics.jsonl"
    events.set_ids(run="RR")
    write_jsonl(str(p), reg)
    reg.gauge("g").set(2.0)
    write_jsonl(str(p), reg)
    snaps = load_snapshots(str(p))
    assert len(snaps) == 2
    assert snaps[0][0]["value"] == 1.0 and snaps[1][0]["value"] == 2.0
    assert snaps[0][0]["trace"]["run"] == "RR"
    assert snaps[0][0]["snap"] < snaps[1][0]["snap"]


# ----------------------------------------- the same streams, both packages

def _stream_reports(obs_dir):
    """A serve run's sensor, journal and span rows as the objects the
    metrics adapters read: one sensor report (the last cumulative rows),
    one control report per journal interval, one guard report per interval
    from its quarantine rows."""
    sensor = [json.loads(ln) for ln in open(obs_dir / "sensor.jsonl")]
    model = [r for r in sensor if r["kind"] == "model"][-1]
    sites = {r["site"]: r for r in sensor if r["kind"] == "site"}
    report = SimpleNamespace(
        model=model, per_site=[SimpleNamespace(**r) for r in sites.values()])
    rows = jload_journal(str(obs_dir / "journal.jsonl"))
    control, guard = [], []
    for iv in (r for r in rows if r["kind"] == "interval"):
        decs = [r for r in rows if r["kind"] == "decision"
                and r["interval"] == iv["interval"]]
        control.append(SimpleNamespace(
            decisions=[SimpleNamespace(kind=d["decision_kind"])
                       for d in decs], retrace=iv["retrace"]))
        quar = [d for d in decs if d["decision_kind"] == "quarantine"]
        guard.append(SimpleNamespace(
            trips=[SimpleNamespace(site=d["site"], check=d["reason"]
                                   .split(":")[0]) for d in quar
                   if d["after"] == "quarantined"],
            stalled=False, quarantined_lanes=len(quar)))
    spans = [json.loads(ln) for ln in open(obs_dir / "spans.jsonl")]
    return report, control, guard, spans


@pytest.fixture(scope="module")
def obs_serve(tmp_path_factory):
    """The port's reduced-qwen3 serve with the controller and --obs-dir,
    its sensor JSONL and journal in the same dir."""
    d = tmp_path_factory.mktemp("obs")
    argv = ["--arch", "qwen3-32b", "--reduced", "--requests", "4",
            "--batch-slots", "2", "--prompt-len", "4", "--cache-len", "24",
            "--max-new", "6", "--reuse", "--device", "cpu",
            "--control-every", "2", "--control-journal",
            str(d / "journal.jsonl"), "--sensor-jsonl", str(d / "sensor.jsonl"),
            "--obs-dir", str(d), "--replica-id", "r7",
            "--profile-dir", str(d / "prof")]
    _reset_obs()
    res = tserve_cli.run(ARCHS["qwen3-32b"].reduced(),
                         tserve_cli.build_parser().parse_args(argv))
    return d, res


def test_metrics_from_the_same_streams_match_reference(obs_serve, tmp_path):
    """Sensor, journal and span rows through both packages' adapters
    (`observe_{sensor,control,guard}_report`, `observe_spans`) make the
    same Prometheus text and the same JSONL snapshots, line for line."""
    report, control, guard, spans = _stream_reports(obs_serve[0])
    out = {}
    for pkg, (mt, ex, ev) in {"port": (metrics, export, events),
                              "ref": (jmetrics, jexport, jevents)}.items():
        reg = mt.MetricsRegistry()
        mt.observe_sensor_report(reg, report)
        for rep, grd in zip(control, guard):
            mt.observe_control_report(reg, rep)
            mt.observe_guard_report(reg, grd)
        mt.observe_spans(reg, spans)
        ex._SNAP_SEQ["n"] = 0
        with ev.context(run="R", replica="r7"):
            ex.write_jsonl(str(tmp_path / f"{pkg}.jsonl"), reg)
        ex.write_prometheus(str(tmp_path / f"{pkg}.prom"), reg)
        out[pkg] = [(tmp_path / f"{pkg}.{ext}").read_text().splitlines()
                    for ext in ("prom", "jsonl")]
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) > 40


def test_serve_obs_dir_on_cpu(obs_serve):
    """`serve --obs-dir --replica-id --profile-dir` on the CPU: one
    serve_step span per decode step and one prefill span per request, rows
    stamped with run and replica, the exports parse back, the latency table
    covers every site x {basic, kernel} and reads "interpret" (the plain
    versions), the trace holds the serve_step ranges, and the obs plane's
    state is put back after the run."""
    d, res = obs_serve
    spans = [json.loads(ln) for ln in open(d / "spans.jsonl")]
    names = [r["name"] for r in spans]
    assert names.count("serve_step") == res["stats"]["steps"]
    assert names.count("prefill") == 4
    assert all(r["trace"]["replica"] == "r7" and r["trace"]["run"]
               for r in spans)
    assert {r["trace"]["replica"] for r in jload_journal(
        str(d / "journal.jsonl"))} == {"r7"}
    parsed = parse_prometheus((d / "metrics.prom").read_text())
    assert parsed["span_serve_step_seconds_count"][""] == res["stats"]["steps"]
    assert parsed["control_intervals"][""] == 5
    assert load_snapshots(str(d / "metrics.jsonl"))
    table = load_latency_table(str(d / "latency_table.json"))
    assert table.meta["arch"] == "qwen3-32b" and table.meta["graphs"] is False
    for name in res["engine"].sites:
        paths = table.paths_for(name)
        assert set(paths) == {"basic", "kernel"}  # gk = 1 at reduced width
        assert all(st.count == 5 for st in paths.values())
    assert table_provenance(table) == "interpret"
    trace = json.loads((d / "prof" / "trace.json").read_text())
    assert sum(e.get("name") == "serve_step" for e in trace["traceEvents"]) \
        == res["stats"]["steps"]
    assert res["profile"] == str(d / "prof" / "trace.json")
    assert not obs_trace.is_enabled() and events.current_ids() == {}


def test_top_renders_a_serve_runs_snapshots(obs_serve, capsys):
    from repro_torch.obs.top import main as top_main

    assert top_main([str(obs_serve[0] / "metrics.jsonl"), "--once"]) == 0
    out = capsys.readouterr().out
    assert "repro_torch.obs.top — snap" in out and "replica=r7" in out
    assert "span_serve_step_seconds" in out


# ------------------------------------------------------------- latency table

def test_latency_table_layer_fallback_and_paths():
    t = LatencyTable()
    t.record("s", None, "basic", 1e-4)
    t.record("s", None, "dense", 8e-5)
    t.record("s", 2, "dense", 5e-5)
    assert t.stat("s", "dense", layer=2).mean_s == pytest.approx(5e-5)
    assert t.stat("s", "dense", layer=7).mean_s == pytest.approx(8e-5)
    assert t.stat("s", "basic", layer=2).mean_s == pytest.approx(1e-4)
    assert t.stat("s", "ragged") is None
    paths = t.paths_for("s", layer=2)
    assert paths["dense"].mean_s == pytest.approx(5e-5)  # layer row wins
    assert paths["basic"].mean_s == pytest.approx(1e-4)


def test_latency_table_save_load_round_trip(tmp_path):
    t = LatencyTable()
    for v in (1e-4, 1.2e-4, 1.4e-4):
        t.record("mlp_in", None, "basic", v)
    t.record("mlp_in", 0, "compact", 4e-5)
    p = tmp_path / "lat.json"
    t.save(str(p), meta={"arch": "qwen3-32b"})
    r = load_latency_table(str(p))
    assert r.meta["arch"] == "qwen3-32b"
    assert len(r) == len(t) == 2
    st, sr = t.stat("mlp_in", "basic"), r.stat("mlp_in", "basic")
    assert sr.count == st.count and sr.mean_s == pytest.approx(st.mean_s)
    assert r.stat("mlp_in", "compact", layer=0).mean_s == pytest.approx(4e-5)

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "nope", "schema_version": 1}))
    with pytest.raises(LatencyTableError, match="obs_latency_table"):
        load_latency_table(str(bad))
    bad.write_text(json.dumps({"kind": "obs_latency_table",
                               "schema_version": 99, "rows": []}))
    with pytest.raises(LatencyTableError, match="schema_version"):
        load_latency_table(str(bad))


def test_build_from_spans_keys_on_tags():
    rows = [
        {"name": "site_probe", "dur_s": 1e-4, "site": "s",
         "exec_path": "basic"},
        {"name": "site_probe", "dur_s": 2e-4, "site": "s",
         "exec_path": "basic"},
        {"name": "serve_step", "dur_s": 9.0},  # no site tag: skipped
    ]
    t = build_from_spans(rows)
    assert len(t) == 1
    assert t.stat("s", "basic").count == 2
    assert t.stat("s", "basic").mean_s == pytest.approx(1.5e-4)


@pytest.mark.parametrize("tracing", [False, True])
def test_probe_latency_table_measures_every_viable_path(tracing):
    engine = ReuseEngine(impl="torch")
    engine.register("s", 64, 32, block_m=2, block_k=32)  # gk=2: compactable
    if tracing:
        obs_trace.enable()
    caches = {}
    table = probe_latency_table(engine, 2, skip_rates={"s": 0.5}, iters=3,
                                warmup=1, device="cpu", caches=caches)
    assert set(table.paths_for("s")) == {BASIC_PATH, "kernel", "ragged"}
    for path, stat in table.paths_for("s").items():
        assert stat.count == 3 and stat.mean_s > 0.0, path
    assert table.meta["impl"] == "torch" and table.meta["batch"] == 2
    # the plain versions on the CPU are the oracle tier, never "compiled"
    assert table_provenance(table) == "interpret"
    assert {r["backend"] for r in table.rows()} == {"torch"}
    # the probe leaves the trace plane on or off as it found it, and its
    # spans in the buffer (as the reference's does)
    assert obs_trace.is_enabled() == tracing
    assert [r["name"] for r in obs_trace.spans()] == ["site_probe"] * 9
    # each path's site cache saw warmup + iters calls
    assert sorted(caches) == [("s", p) for p in ("basic", "kernel", "ragged")]
    assert all(int(c["steps"]) == 4 for c in caches.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_latency_table(engine, 2)


def test_probe_draws_the_reference_inputs(monkeypatch):
    """The probe draws the reference's activations and weights, in its
    order, from the same seed, so a seed gives the reference's skip
    pattern: every array the reference hands to jnp.asarray, the port hands
    to torch.from_numpy."""
    drawn = {"ref": [], "port": []}
    asarray, from_numpy = jax.numpy.asarray, torch.from_numpy

    def rec_asarray(a, *args, **kw):
        if isinstance(a, np.ndarray) and a.dtype == np.float32:
            drawn["ref"].append(a.copy())
        return asarray(a, *args, **kw)

    def rec_from_numpy(a):
        drawn["port"].append(a.copy())
        return from_numpy(a)

    jeng, teng = JEngine(), ReuseEngine(impl="torch")
    for eng in (jeng, teng):
        eng.register("s", 96, 32, block_m=2, block_k=32)
        eng.register("t", 64, 48, block_m=2, block_k=32)
    skips = {"s": 0.3, "t": 0.9}
    monkeypatch.setattr(jax.numpy, "asarray", rec_asarray)
    jlatency.probe_latency_table(jeng, 2, skip_rates=skips, iters=1,
                                 warmup=1, seed=3)
    monkeypatch.setattr(jax.numpy, "asarray", asarray)
    monkeypatch.setattr(torch, "from_numpy", rec_from_numpy)
    probe_latency_table(teng, 2, skip_rates=skips, iters=1, warmup=1,
                        seed=3, device="cpu")
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    # the reference converts x_a, x_b, then w; the port w, then x_a, x_b
    ref = drawn["ref"]
    ref = [a for i in range(0, len(ref), 3) for a in
           (ref[i + 2], ref[i], ref[i + 1])]
    assert len(ref) == len(drawn["port"]) == 6
    for a, b in zip(ref, drawn["port"]):
        np.testing.assert_array_equal(a, b)


def test_latency_tables_cross_load_both_ways(tmp_path):
    """A table saved by either package loads in the other with equal rows
    and provenance: the reference's jnp probe (basic/dense/compact, compiled
    XLA) and the port's CPU probe (basic/kernel/ragged, the plain
    versions)."""
    jeng, teng = JEngine(), ReuseEngine(impl="torch")
    for eng in (jeng, teng):
        eng.register("s", 64, 32, block_m=2, block_k=32)
    kw = dict(skip_rates={"s": 0.5}, iters=2, warmup=1)
    saved = {
        "ref": jlatency.probe_latency_table(jeng, 2, **kw),
        "port": probe_latency_table(teng, 2, device="cpu", **kw),
    }
    for who, table in saved.items():
        path = str(tmp_path / f"{who}.json")
        table.save(path, meta={"arch": "qwen3-32b"})
        a, b = load_latency_table(path), jlatency.load_latency_table(path)
        assert a.rows() == b.rows() and a.meta == b.meta
        assert table_provenance(a) == jlatency.table_provenance(b)
    assert table_provenance(load_latency_table(str(tmp_path / "ref.json"))) \
        == "compiled"
    assert jlatency.table_provenance(jlatency.load_latency_table(
        str(tmp_path / "port.json"))) == "interpret"


def test_controller_loads_its_latency_table_path(tmp_path):
    t = LatencyTable()
    t.record("s", None, "basic", 1e-4, tags=CARD)
    t.save(str(tmp_path / "lat.json"))
    ctl = tctl.Controller(tctl.ControlConfig(
        latency_table_path=str(tmp_path / "lat.json")))
    assert ctl.latency.rows() == t.rows()


# ------------------------------------------- measured pricing in the fitter

def _rec(cls=SiteTraceRecord, **kw):
    base = dict(
        site="mlp_in", mode="reuse", steps=10, batch=4,
        in_features=512, out_features=256, block_m=8, block_k=128,
        block_n=128, tile_skip_rate=0.8, mac_skip_rate=0.7,
        weight_byte_skip_rate=0.7, hit_rate=0.9, mode_transitions=0,
        suppressed_flips=0, total_weight_bytes=0.0, total_macs=0.0,
    )
    base.update(kw)
    return cls(**base)


def _table(mod, rows):
    lat = mod.LatencyTable()
    for path, seconds in rows.items():
        lat.record("mlp_in", None, path, seconds)
    return lat


def test_fit_with_latency_table_changes_tunables():
    """The same operating point solves to different tunables when priced
    from MEASURED wall-clock: the constant skip-rate gate promotes the
    compacted tier, the measurement (the masked walk fastest) demotes."""
    rec = _rec()
    lat = _table(tlatency,
                 {"basic": 100e-6, "dense": 80e-6, "compact": 150e-6})
    const = solve_site(rec, FitConfig())
    meas = solve_site(rec, FitConfig(latency=lat))
    assert const.exec_path == "compact"       # constant gate: skip >= 0.25
    assert meas.exec_path is None             # measured gate: dense fastest
    assert meas.sim_threshold != pytest.approx(const.sim_threshold)
    lat2 = _table(tlatency,
                  {"basic": 100e-6, "dense": 80e-6, "compact": 30e-6})
    fast = solve_site(rec, FitConfig(latency=lat2))
    assert fast.exec_path == "compact" and fast.max_active_k is not None
    note = measured_latency_note(rec, FitConfig(latency=lat))
    assert note is not None and note.startswith("measured basic=")
    assert measured_latency_note(rec, FitConfig()) is None


def test_measured_pricing_falls_back_without_coverage():
    rec = _rec()
    empty = LatencyTable()
    no_basic = LatencyTable()
    no_basic.record(rec.site, None, "dense", 80e-6)
    for cfg in (FitConfig(latency=empty), FitConfig(latency=no_basic)):
        assert solve_site(rec, cfg) == solve_site(rec, FitConfig())


PRICES = [
    {"basic": 100e-6, "kernel": 150e-6, "ragged": 40e-6},
    {"basic": 100e-6, "kernel": 80e-6, "ragged": 120e-6},
    {"basic": 100e-6, "kernel": 300e-6},
    {"basic": 100e-6, "dense": 80e-6, "compact": 30e-6},
]


@pytest.mark.parametrize("prices", PRICES)
@pytest.mark.parametrize("pallas_target", [False, True])
def test_solve_site_priced_by_a_table_matches_reference(prices, pallas_target):
    """One fixed table, each package's own table class and solver: equal
    tunables and equal measured-evidence notes, at a high-skip and a
    low-hit operating point."""
    from repro.tune.harvest import measured_latency_note as jnote

    for kw in ({}, dict(tile_skip_rate=0.1, hit_rate=0.2)):
        port = solve_site(_rec(**kw), FitConfig(
            pallas_target=pallas_target,
            latency=_table(tlatency, prices)))
        jcfg = JFit(pallas_target=pallas_target,
                    latency=_table(jlatency, prices))
        ref = jsolve_site(_rec(JRecord, **kw), jcfg)
        assert port.to_dict() == ref.to_dict()
        assert measured_latency_note(_rec(**kw), FitConfig(
            latency=_table(tlatency, prices))) \
            == jnote(_rec(JRecord, **kw), jcfg)


def test_measured_compact_pin_reaches_the_port_and_names_the_path():
    """A table from the reference's jnp engines carries dense and compact
    rows; where compact measures fastest, the controller pins it — also on
    the port, whose fit_cfg targets ragged — and the port's serve path,
    which does not run compact yet, raises naming it."""
    from repro_torch.sensor.runner import run_measured_decode

    lat = LatencyTable()
    for site in ("attn_qkv", "attn_out", "mlp_in", "mlp_out"):
        for path, s in (("basic", 100e-6), ("dense", 90e-6),
                        ("compact", 20e-6)):
            lat.record(site, None, path, s, tags=CARD)
    ctl = tctl.Controller(tctl.ControlConfig(min_window_steps=2), latency=lat)
    pinned = []

    def on_step(i, engine, cache):
        if i % 2 == 0:
            rep = ctl.step(engine, cache, step=i)
            pinned.extend(d for d in rep.decisions
                          if d.field == "exec_path" and d.after == "compact")

    with pytest.raises(ValueError, match="exec_path 'compact' .* not "
                       "available"):
        run_measured_decode("qwen3-32b", steps=12, batch=2, correlation=1.0,
                            device="cpu", on_step=on_step)
    assert pinned


# ------------------------------- one table, both packages' serve and fit CLI

def _fixed_table(path):
    """Reuse slower than basic at attn_qkv and mlp_out, faster at the
    others: measured pricing demotes where constant pricing would not."""
    lat = LatencyTable()
    for site, basic, kernel in (("attn_qkv", 100e-6, 150e-6),
                                ("attn_out", 100e-6, 60e-6),
                                ("mlp_in", 100e-6, 80e-6),
                                ("mlp_out", 100e-6, 200e-6)):
        for _ in range(3):
            lat.record(site, None, "basic", basic, tags=CARD)
            lat.record(site, None, "kernel", kernel, tags=CARD)
    lat.save(str(path))
    return str(path)


SERVE = ["--arch", "qwen3-32b", "--reduced", "--requests", "4",
         "--batch-slots", "2", "--prompt-len", "4", "--cache-len", "24",
         "--max-new", "6", "--reuse", "--control-every", "2"]


def _rows(path):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in jload_journal(str(path))]


@pytest.fixture(scope="module")
def priced_serves(tmp_path_factory):
    """`serve --control-every 2 --latency-table T` on reduced qwen3 in both
    packages: the reference's engine at impl="pallas" (so both fit the
    kernel tier), the port given the reference's weights."""
    from repro.launch import serve as jserve_cli

    d = tmp_path_factory.mktemp("priced")
    table = _fixed_table(d / "lat.json")
    mp = pytest.MonkeyPatch()
    build = jserve_cli.build_reuse_engine
    mp.setattr(jserve_cli, "build_reuse_engine",
               lambda cfg, *, impl="jnp", policy=None: build(
                   cfg, impl="pallas", policy=policy))
    mp.setattr(sys, "argv", ["serve", *SERVE, "--latency-table", table,
                             "--control-journal", str(d / "ref.jsonl")])
    _reset_obs()
    jserve_cli.main()
    tree = jax.tree.map(np.asarray, jinit_params(
        JARCHS["qwen3-32b"].reduced(), jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, ARCHS["qwen3-32b"].reduced(), "cpu")
    mp.setattr(tserve_cli, "init_params", lambda cfg, seed, device: params)
    out = {}
    for name, extra in (("port", ["--latency-table", table]),
                        ("const", [])):
        out[name] = tserve_cli.run(
            ARCHS["qwen3-32b"].reduced(),
            tserve_cli.build_parser().parse_args(
                SERVE + extra + ["--control-journal",
                                 str(d / f"{name}.jsonl"),
                                 "--device", "cpu"]))
    mp.undo()
    return d, out


def test_serve_priced_by_a_latency_table_matches_reference(priced_serves):
    d, out = priced_serves
    port, ref = _rows(d / "port.jsonl"), _rows(d / "ref.jsonl")
    assert port == ref
    decisions = [r for r in port if r["kind"] == "decision"]
    assert any("measured basic=" in r["reason"] for r in decisions)
    # the table moved the decisions: constant pricing journals otherwise
    assert _rows(d / "const.jsonl") != port
    assert out["port"]["controller"].latency is not None


def test_serve_latency_table_needs_control_every(capsys, monkeypatch,
                                                 tmp_path):
    from repro.launch import serve as jserve_cli

    argv = ["--arch", "qwen3-32b", "--reduced", "--reuse",
            "--latency-table", str(_fixed_table(tmp_path / "t.json"))]
    with pytest.raises(ValueError) as e:
        tserve_cli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit):
        jserve_cli.main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert str(e.value) == ref_err.split("error: ")[1] == \
        "--latency-table requires --control-every"


def test_fit_cli_latency_table_matches_reference(obs_serve, tmp_path,
                                                 monkeypatch, capsys):
    """`tune.fit --latency-table` on the same trace and table writes the
    reference's tuned table, with the reference's provenance warning for a
    table from the plain versions."""
    from repro.tune import fit as jfit
    from repro_torch.tune import fit as tfit

    d = obs_serve[0]
    outputs = {}
    for name, mod in (("port", tfit), ("ref", jfit)):
        out = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", [
            "fit", "--trace", str(d / "sensor.jsonl"), "--out", str(out),
            "--latency-table", str(d / "latency_table.json")])
        mod.main()
        text = capsys.readouterr().out
        doc = json.loads(out.read_text())
        outputs[name] = (doc["sites"], [ln for ln in text.splitlines()
                                        if ln.startswith(("WARNING",
                                                          "pricing"))])
    assert outputs["port"] == outputs["ref"]
    assert outputs["port"][1][1].startswith(
        "WARNING: latency table") and "interpret measurements" in \
        outputs["port"][1][1]
