"""The port's tuning loop against the reference's, on the CPU: sensor JSONL
rows and traces (`sensor.aggregate`, `tune.trace`), the cost model
(`sensor.cost_model`), the fitter (`tune.harvest`, `tune.fit`), tuned tables
(`tune.table`) and `serve --sensor-jsonl`.

Traces cross both ways: a trace the port writes loads in
`repro.tune.trace.load_trace`, one the reference writes loads in the port's,
and both loaders give equal records. Fits of one trace are equal in both
packages, and both write byte-identical tables. Reduced models with the
reference's weights (`repro.models.init_params`, through `params_from_numpy`).
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

from repro import tune as jtune
from repro.obs import events as jevents
from repro.sensor import cost_model as jcost
from repro.sensor import runner as jrunner
from repro.tune import fit as jfit
from repro.tune import harvest as jharvest
from repro.tune import table as jtable
from repro.tune import trace as jtrace
from repro_torch import tune as ttune
from repro_torch.launch import serve as tserve_cli
from repro_torch.obs import events as tevents
from repro_torch.roofline import model_cost as tmodel_cost
from repro_torch.sensor import aggregate as tagg
from repro_torch.sensor import cost_model as tcost
from repro_torch.sensor import runner as trunner
from repro_torch.tune import fit as tfit
from repro_torch.tune import harvest as tharvest
from repro_torch.tune import table as ttable
from repro_torch.tune import trace as ttrace
from test_torch_measured import reference_params

STEPS, BATCH = 6, 2


@pytest.fixture(scope="module")
def runs():
    """{arch: port MeasuredDecode} at correlation 0.95, and the reference's
    qwen3 run on the same weights and stream."""
    out = {arch: trunner.run_measured_decode(
        arch, steps=STEPS, batch=BATCH, correlation=0.95, device="cpu",
        params=reference_params(arch)) for arch in ("qwen3-32b", "rwkv6-7b")}
    out["reference"] = jrunner.run_measured_decode(
        "qwen3-32b", steps=STEPS, batch=BATCH, correlation=0.95)
    return out


def records(trace):
    """A trace's records as plain dicts (each package has its own record
    class): the site records, the layer records, the model row."""
    return ({n: dataclasses.asdict(r) for n, r in trace.sites.items()},
            {n: {layer: dataclasses.asdict(r) for layer, r in by.items()}
             for n, by in trace.layers.items()},
            trace.model, trace.n_rows)


def write(report, path, ids, events):
    if ids:
        with events.context(**ids):
            report.write_jsonl(str(path))
    else:
        report.write_jsonl(str(path))
    return [json.loads(ln) for ln in path.read_text().splitlines()]


# ----------------------------------------------------------- JSONL + traces

@pytest.mark.parametrize("ids", [None, {"run": "r0", "replica": 3}])
def test_port_trace_loads_in_both_loaders(runs, tmp_path, ids):
    path = tmp_path / "port.jsonl"
    rows = write(runs["qwen3-32b"].report, path, ids, tevents)
    assert [r["kind"] for r in rows[:2]] == ["model", "site"]
    assert all(r["schema_version"] == tagg.SENSOR_SCHEMA_VERSION == 6
               for r in rows)
    assert all(r.get("trace") == ids for r in rows)
    jt, tt = jtrace.load_trace(str(path)), ttrace.load_trace(str(path))
    assert records(jt) == records(tt)
    assert set(tt.sites) == {"attn_qkv", "attn_out", "mlp_in", "mlp_out"}
    assert set(tt.layers["attn_qkv"]) == {0, 1}
    assert tt.sites["attn_qkv"].exec_path == "kernel"
    assert not tevents.current_ids()


@pytest.mark.parametrize("ids", [None, {"run": "r1", "replica": 0}])
def test_reference_trace_loads_in_both_loaders(runs, tmp_path, ids):
    """The reference writes its report; the port writes its own of the same
    run: rows equal but for exec_path, and both load the same in both
    loaders."""
    jrows = write(runs["reference"].report, tmp_path / "ref.jsonl", ids,
                  jevents)
    trows = write(runs["qwen3-32b"].report, tmp_path / "port.jsonl", ids,
                  tevents)
    assert [{k: v for k, v in r.items() if k != "exec_path"} for r in jrows] \
        == [{k: v for k, v in r.items() if k != "exec_path"} for r in trows]
    ref = str(tmp_path / "ref.jsonl")
    assert records(jtrace.load_trace(ref)) == records(ttrace.load_trace(ref))
    assert ttrace.load_trace(ref).sites["mlp_in"].exec_path == "dense"


def test_to_dicts_match_reference_classes(runs):
    """The port's rows are what the reference's SensorReport writes for the
    same counters: rebuild one in the reference's classes."""
    from repro.sensor import aggregate as jagg

    rep = runs["rwkv6-7b"].report
    jrep = jagg.SensorReport(
        per_site=[jagg.SiteSensor(**dataclasses.asdict(s))
                  for s in rep.per_site],
        per_layer=[jagg.SiteSensor(**dataclasses.asdict(s))
                   for s in rep.per_layer],
        model=dict(rep.model))
    assert rep.to_dicts() == jrep.to_dicts()
    assert json.dumps(rep.to_dicts()) == json.dumps(jrep.to_dicts())


def versioned_row(row, version):
    """A v6 site row as an older build wrote it: without the fields added
    after `version`."""
    added = {3: ("grid_steps", "exec_path", "grid_step_skip_rate"),
             4: ("overflow_fallbacks",), 5: ("budget_occupancy",),
             6: ("sentinel_trips",)}
    row = dict(row, schema_version=version)
    for v, keys in added.items():
        if v > version:
            for k in keys:
                row.pop(k, None)
    return row


@pytest.mark.parametrize("version", [None, 1, 2, 3, 4, 5, 6, 7])
def test_trace_schema_versions(runs, tmp_path, version):
    rows = runs["qwen3-32b"].report.to_dicts()
    site = next(r for r in rows if r["kind"] == "site")
    row = versioned_row(site, version if version else 6)
    if version is None:
        row.pop("schema_version")
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps(row) + "\n")
    if version in (None, 1, 7):
        for load in (ttrace.load_trace, jtrace.load_trace):
            with pytest.raises(ValueError, match="schema_version"):
                load(str(path))
        with pytest.raises(ttrace.TraceSchemaError):
            ttrace.load_trace(str(path))
        return
    assert version in ttrace.SUPPORTED_SCHEMA_VERSIONS
    assert ttrace.SUPPORTED_SCHEMA_VERSIONS == \
        jtrace.SUPPORTED_SCHEMA_VERSIONS == (2, 3, 4, 5, 6)
    tt = ttrace.load_trace(str(path))
    assert records(tt) == records(jtrace.load_trace(str(path)))
    rec = tt.sites["attn_qkv"]
    assert rec.exec_path == (site["exec_path"] if version >= 3 else "auto")
    assert rec.overflow_fallbacks == 0
    assert rec.work_flops == 2.0 * rec.in_features * rec.out_features
    assert 0.0 <= rec.harvest_efficiency <= 1.0


def test_trace_rejects_rows_without_geometry_or_sites(runs, tmp_path):
    site = next(r for r in runs["qwen3-32b"].report.to_dicts()
                if r["kind"] == "site")
    path = tmp_path / "t.jsonl"
    for row, match in ((dict(site, in_features=0), "no geometry"),
                       ({k: v for k, v in site.items() if k != "block_k"},
                        "missing"),
                       (dict(site, kind="model"), "no site rows")):
        path.write_text(json.dumps(row) + "\n")
        with pytest.raises(ttrace.TraceSchemaError, match=match):
            ttrace.load_trace(str(path))
    path.write_text("{not json\n")
    with pytest.raises(ttrace.TraceSchemaError, match="not JSON"):
        ttrace.load_trace(str(path))


def test_serve_sensor_jsonl_on_cpu(tmp_path, capsys):
    path = tmp_path / "serve.jsonl"
    argv = ["--arch", "rwkv6-7b", "--reduced", "--requests", "2",
            "--batch-slots", "2", "--prompt-len", "4", "--cache-len", "16",
            "--max-new", "3", "--reuse", "--device", "cpu",
            "--sensor-jsonl", str(path)]
    tserve_cli.main(argv)
    tserve_cli.main(argv)  # appends: the last report per site wins
    assert f"sensor report appended to {path}" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(rows) == 2 * (1 + 8 + 8 * 2)
    tt, jt = ttrace.load_trace(str(path)), jtrace.load_trace(str(path))
    assert records(tt) == records(jt)
    assert tt.n_rows == len(rows)
    assert len(tt.sites) == 8 and tt.model["steps"] > 0
    with pytest.raises(ValueError, match="--sensor-jsonl requires --reuse"):
        tserve_cli.main([a for a in argv if a != "--reuse"])


# ---------------------------------------------------------------- cost model

def test_cost_model_constants():
    for name in ("E_MAC", "E_HBM", "E_ICI", "STATIC_W", "FLOPS_PER_MAC"):
        assert getattr(tcost, name) == getattr(jcost, name), name
    # the H100 SXM5 datasheet figures, not the reference's TPU ones
    assert (tmodel_cost.PEAK_FLOPS, tmodel_cost.HBM_BW) == (989e12, 3.35e12)
    assert (tcost.PEAK_FLOPS, tcost.HBM_BW) == (989e12, 3.35e12)
    from repro import sensor as jsensor
    from repro_torch import sensor as tsensor
    assert tsensor.__all__ == jsensor.__all__


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_cost_model_matches_reference(runs, monkeypatch, arch):
    rep = runs[arch].report
    assert tcost.sensor_energy(rep) == jcost.sensor_energy(rep)
    assert tcost.measured_skip_fractions(rep) == \
        jcost.measured_skip_fractions(rep)
    assert tcost.sensor_speedup(rep) != jcost.sensor_speedup(rep)
    monkeypatch.setattr(jcost, "PEAK_FLOPS", tcost.PEAK_FLOPS)
    monkeypatch.setattr(jcost, "HBM_BW", tcost.HBM_BW)
    assert tcost.sensor_speedup(rep) == jcost.sensor_speedup(rep)
    sharded = dataclasses.replace(rep, model=dict(
        rep.model, ici_reduce_bytes=1e6, ici_ctrl_write_bytes=2e5))
    assert tcost.sensor_energy(sharded) == jcost.sensor_energy(sharded)
    assert "ici_j" in tcost.sensor_energy(sharded)


# ------------------------------------------------------------------ fitting

FITS = {
    "default": dict(),
    "pallas_target": dict(pallas_target=True),
    "site_only": dict(per_layer=False),
    "measured_gate": dict(pallas_target=True, ragged_min_skip=0.9,
                          safety_margin=1.5),
}


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b", "reference"])
@pytest.mark.parametrize("fit", list(FITS))
def test_fit_trace_matches_reference(runs, tmp_path, arch, fit):
    path = str(tmp_path / "trace.jsonl")
    runs[arch].report.write_jsonl(path)
    kw = dict(FITS[fit])
    per_layer = kw.pop("per_layer", True)
    jt, tt = jtrace.load_trace(path), ttrace.load_trace(path)
    jtab = jfit.fit_trace(jt, jharvest.FitConfig(**kw), per_layer=per_layer)
    ttab = tfit.fit_trace(tt, tharvest.FitConfig(**kw), per_layer=per_layer)
    assert {n: t.to_dict() for n, t in jtab.items()} == \
        {n: t.to_dict() for n, t in ttab.items()}
    assert jfit.summary_lines(jt, jtab) == tfit.summary_lines(tt, ttab)
    assert any("@" in n for n in ttab) == per_layer
    if arch == "qwen3-32b" and fit == "pallas_target":
        # 83% tile skip: every site is promoted to the compacted walk
        assert {ttab[s].exec_path for s in tt.sites} == {"ragged"}
    if fit == "measured_gate":
        # a gate above every measured skip promotes nothing
        assert all(ttab[s].exec_path is None for s in tt.sites)
    for save, load in ((jtable.save_table, ttable.load_table),
                       (ttable.save_table, jtable.load_table)):
        out = str(tmp_path / f"{save.__module__}.json")
        save(out, ttab, meta={"trace": path})
        assert {n: t.to_dict() for n, t in load(out).items()} == \
            {n: t.to_dict() for n, t in ttab.items()}
    files = [(tmp_path / f"{m}.json").read_bytes()
             for m in ("repro.tune.table", "repro_torch.tune.table")]
    assert files[0] == files[1]


@pytest.mark.parametrize("flags", [[], ["--pallas-target"],
                                   ["--site-only", "--safety-margin", "1.5",
                                    "--prior-efficiency", "0.6"]])
def test_fit_clis_write_identical_tables(runs, tmp_path, monkeypatch,
                                         capsys, flags):
    trace = str(tmp_path / "trace.jsonl")
    runs["qwen3-32b"].report.write_jsonl(trace)
    outs = {}
    for name, main in (("ref", jfit.main), ("port", tfit.main)):
        outs[name] = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", ["fit", "--trace", trace, "--out",
                                          str(outs[name]), *flags])
        main()
        printed = capsys.readouterr().out
        assert f"tuned table written to {outs[name]}" in printed
    assert outs["ref"].read_bytes() == outs["port"].read_bytes()
    policy = ttable.load_tuned_policy(str(outs["ref"]))
    assert set(policy.site_tunables) == set(
        jtable.load_tuned_policy(str(outs["port"])).site_tunables)


def test_derive_break_even_skip_reference_cases():
    from repro_torch.core.policy import RAGGED_BREAK_EVEN_SKIP

    derive = tharvest.derive_break_even_skip
    assert derive([]) == RAGGED_BREAK_EVEN_SKIP == 0.25
    pts = [(0.0, 2.0, 1.0), (0.5, 1.0, 1.0), (1.0, 0.5, 1.0)]
    assert derive(pts) == pytest.approx(0.5)
    pts = [(0.0, 1.5, 1.0), (0.5, 0.5, 1.0)]  # crossing inside the segment
    assert derive(pts) == pytest.approx(0.25)
    assert derive([(s, 2.0, 1.0) for s in (0.0, 0.5, 0.9)]) == 2.0
    assert derive([(0.1, 0.5, 1.0), (0.9, 0.2, 1.0)]) == pytest.approx(0.1)
    rng = np.random.default_rng(4)
    for _ in range(50):
        pts = [(float(s), float(r), float(d)) for s, r, d in zip(
            rng.permutation([0.0, 0.25, 0.5, 0.75, 0.9]),
            rng.uniform(0.5, 1.5, 5), rng.uniform(0.5, 1.5, 5))]
        assert derive(pts) == jharvest.derive_break_even_skip(pts)


def test_record_from_sensor_and_solve_match_reference(runs):
    """record_from_sensor on the port's SiteSensors equals the reference's on
    the reference's SiteSensors of the same run (but exec_path), and the
    solver, costs and block_k pick agree on every record."""
    t_rep, j_rep = runs["qwen3-32b"].report, runs["reference"].report
    for ts, js in zip(t_rep.per_site + t_rep.per_layer,
                      j_rep.per_site + j_rep.per_layer):
        tr = tharvest.record_from_sensor(ts)
        jr = jharvest.record_from_sensor(js)
        assert dataclasses.asdict(tr) == dict(dataclasses.asdict(jr),
                                              exec_path="kernel")
        assert dataclasses.asdict(tharvest.record_from_sensor(
            ts, mode="basic"))["mode"] == "basic"
        jr = jharvest.record_from_sensor(ts)  # the port's sensor, duck-typed
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert tharvest.per_step_costs(tr) == jharvest.per_step_costs(jr)
        for cfg in (dict(), dict(pallas_target=True), dict(low_efficiency=0.99),
                    dict(high_efficiency=0.01)):
            tc, jc = tharvest.FitConfig(**cfg), jharvest.FitConfig(**cfg)
            assert tharvest.pick_block_k(tr, 0.7, tc) == \
                jharvest.pick_block_k(jr, 0.7, jc)
            assert tharvest.solve_site(tr, tc).to_dict() == \
                jharvest.solve_site(jr, jc).to_dict()


class _Stat:
    def __init__(self, mean_s):
        self.mean_s = mean_s


class _Latency:
    """A stand-in for the reference's LatencyTable: `.stat` and
    `.paths_for`, all that `measured_costs` reads."""

    def __init__(self, table):
        self.table = table

    def stat(self, site, path, layer=None):
        t = self.table.get(path)
        return None if t is None else _Stat(t)

    def paths_for(self, site, layer=None):
        return {p: _Stat(t) for p, t in self.table.items()}


@pytest.mark.parametrize("table", [
    {"basic": 1e-4, "kernel": 8e-5, "ragged": 5e-5},
    {"basic": 1e-4, "kernel": 2e-4},
    {"kernel": 1e-4},
])
def test_measured_costs_match_reference(runs, table):
    lat = _Latency(table)
    for s in runs["qwen3-32b"].report.per_site:
        rec = tharvest.record_from_sensor(s)
        jrec = jharvest.record_from_sensor(s)
        tc = tharvest.FitConfig(latency=lat, pallas_target=True)
        jc = jharvest.FitConfig(latency=lat, pallas_target=True)
        assert tharvest.measured_costs(rec, tc, 0.7) == \
            jharvest.measured_costs(jrec, jc, 0.7)
        assert tharvest.measured_latency_note(rec, tc) == \
            jharvest.measured_latency_note(jrec, jc)
        assert tharvest.solve_site(rec, tc).to_dict() == \
            jharvest.solve_site(jrec, jc).to_dict()
    assert (tharvest.measured_latency_note(rec, tc) is None) == \
        ("basic" not in table)


def test_tune_exports_match_reference():
    assert ttune.__all__ == jtune.__all__
    assert tfit.__all__ == jfit.__all__
    assert (ttable.TUNED_TABLE_SCHEMA_VERSION, ttable.TUNED_TABLE_KIND) == \
        (jtable.TUNED_TABLE_SCHEMA_VERSION, jtable.TUNED_TABLE_KIND)
    assert (tharvest.BLOCK_K_CHOICES, tharvest.BOOKKEEP_BYTES_PER_XK,
            tharvest.BOOKKEEP_BYTES_PER_MN) == (
        jharvest.BLOCK_K_CHOICES, jharvest.BOOKKEEP_BYTES_PER_XK,
        jharvest.BOOKKEEP_BYTES_PER_MN)
    tf, jf = tharvest.FitConfig(), jharvest.FitConfig()
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)


def test_events_match_reference():
    for ev in (tevents, jevents):
        ev.clear_ids()
        assert ev.stamp({"a": 1}) == {"a": 1}
        with ev.context(run="x", window=2):
            with ev.context(window=3, request=7):
                assert ev.current_ids() == {"run": "x", "window": 3,
                                            "request": 7}
            assert ev.stamp({"a": 1}) == {"a": 1, "trace": {"run": "x",
                                                            "window": 2}}
        assert ev.current_ids() == {}
        ev.set_ids(run="y", replica=None)
        ev.clear_ids("run")
        assert ev.current_ids() == {}
        assert len(ev.new_run_id()) == 12
