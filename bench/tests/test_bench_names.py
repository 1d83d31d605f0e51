"""BENCHMARK.json against the contract's shape, and every name in it
resolved to its file: configurations, traffic mixes, per-layer metric
readers and each cell's limits."""

import json
import re

import pytest

from bench import cell, cost, families, generator
from bench.tests.helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs_resolve(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("bench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == []
        assert set(conf["reuse"]) == {"block_m", "block_k", "fixed_scale"}
        assert 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_resolve(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        spec = cell.load_spec(ROOT, w["name"])
        generator.check(spec.traffic)
        assert spec.limits and all(v > 0 for v in spec.limits.values())
        assert set(spec.limits) <= {"logit_gap_mean", "logit_gap"}
        assert spec.check_cohorts >= 2
        assert [m["name"] for m in spec.end_to_end] == [
            "decode_tok_s", "itl_ms_p95", "setup_s"]
        assert spec.per_layer


def test_metrics_resolve(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        path = BENCH / "metrics" / f"{m['name']}.py"
        text = path.read_text()
        assert (f'UNIT, LAYER, MOVES = "{m["unit"]}", "{m["layer"]}", '
                f'"{m["moves"]}"') in text, m["name"]
        assert callable(cell.metric_reader(m["name"]))
    for w in cells:
        metrics = [m for m in bench["per_layer"] if w in m["workloads"]]
        assert any(m["moves"] == "decode_tok_s" for m in metrics)


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        cell.load_spec(ROOT, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        cell.metric_reader("no_such_metric")


def test_families_resolve(bench):
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        fam = families.load(conf["reference"])
        for name in ("logits", "make_weights", "site_shapes", "step_extra"):
            assert callable(getattr(fam, name)), (conf["reference"], name)
        assert isinstance(fam.PORT_KEYS, dict)
        for key in fam.PORT_CONSTANTS:
            assert key in conf, (conf["reference"], key)
        assert cell.port_config(conf).n_layers == conf["n_layers"]


def test_an_unknown_family_fails():
    conf = json.loads((BENCH / "configs" / "rwkv6_7b.json").read_text())
    conf["reference"] = "no_such_family"
    with pytest.raises(KeyError):
        families.load("no_such_family")
    with pytest.raises(KeyError):
        cost.sites(conf)
    with pytest.raises(KeyError):
        cost.step_work(conf, {}, 1, 8, 1.0)


def test_a_size_the_program_fixes_has_to_match():
    conf = json.loads((BENCH / "configs" / "rwkv6_7b.json").read_text())
    conf["time_mix_lora"] = 64
    with pytest.raises(ValueError, match="time_mix_lora"):
        cell.port_config(conf)
