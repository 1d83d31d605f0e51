"""The four `program_span` readers on synthetic program records: each
reads its number from the device records, and reports nothing where the
stretch has no device records, lost some, or was not served; on the CPU
the stretch yields no device record."""

import types

import pytest

from bench import cell, program_trace, weights
from bench.tests.helpers import tiny_spec

SEED = 2**31 + 11
READERS = ["device_ms.decode", "host_wait_ms.step", "site_ms.decode",
           "site_epilogue_ms.decode"]


def _replay(span_id, t0_ms, t1_ms, marked=False, marks=True):
    rec = {"name": program_trace.DECODE_REPLAY, "span_id": span_id + 100,
           "parent_id": span_id, "dev_t0": t0_ms / 1e3,
           "dev_t1": t1_ms / 1e3, "dur_s": (t1_ms - t0_ms) / 1e3,
           "marked": marked}
    if marked and marks:
        rec["marks"] = [["attn_qkv", 0, "quant", 1.0],
                        ["attn_qkv", 0, "product", 4.0],
                        ["attn_qkv", 0, "epilogue", 0.5],
                        ["attn_qkv", 1, "quant", 1.0],
                        ["attn_qkv", 1, "product", 2.0],
                        ["attn_qkv", 1, "epilogue", 1.5],
                        ["mlp_in", 0, "quant", 0.5],
                        ["mlp_in", 0, "product", 3.0],
                        ["mlp_in", 0, "epilogue", 0.25],
                        ["head", 0, "head", 2.0]]
    return rec


def _host(name, span_id, t0_ms, t1_ms):
    return {"name": name, "span_id": span_id, "parent_id": 0,
            "t0": t0_ms / 1e3, "t1": t1_ms / 1e3,
            "dur_s": (t1_ms - t0_ms) / 1e3}


def _ctx(records, dropped=0):
    ctx = types.SimpleNamespace()
    ctx.program = {"records": records, "dropped": dropped, "steps": 3,
                   "wall_s": 0.06}
    return ctx


def _stretch():
    """Four replays, unmarked ones of 17 ms and marked ones of 19 ms, 3 ms
    apart; 0.2 ms of `obs.resolve` in the first gap, 1 ms in the second,
    one span partly in the third and one outside every gap."""
    return [_host("compiled_step.decode", 1, 0.0, 0.5),
            _replay(1, 0.2, 17.2),
            _host("obs.resolve", 5, 17.4, 17.6),    # 0.2 ms in gap 1
            _host("compiled_step.decode", 2, 17.3, 20.5),
            _replay(2, 20.2, 39.2, marked=True),
            _host("obs.resolve", 6, 40.0, 41.0),    # 1 ms in gap 2
            _host("compiled_step.decode", 3, 39.3, 42.5),
            _replay(3, 42.2, 59.2),
            _host("obs.resolve", 7, 61.5, 63.0),    # 0.7 ms in gap 3
            _host("compiled_step.decode", 4, 59.3, 62.5),
            _replay(4, 62.2, 81.2, marked=True),
            _host("obs.resolve", 8, 81.5, 82.0)]    # after the last


def test_readers_read_the_device_records():
    ctx = _ctx(_stretch())
    read = {n: cell.metric_reader(n) for n in READERS}
    assert read["device_ms.decode"](ctx) == pytest.approx(17.0)
    # gaps of 3 ms less 0.2, 1 and 0.7 ms of resolution
    assert read["host_wait_ms.step"](ctx) == pytest.approx(
        (2.8 + 2.0 + 2.3) / 3)
    assert read["site_ms.decode"](ctx) == pytest.approx(13.75)
    assert read["site_epilogue_ms.decode"](ctx) == pytest.approx(2.25)


def test_readers_report_nothing_without_device_records():
    host_only = [r for r in _stretch() if "dev_t0" not in r]
    for name in READERS:
        read = cell.metric_reader(name)
        assert read(_ctx(host_only)) is None, name
        assert read(_ctx([])) is None, name


def test_readers_report_nothing_where_records_were_lost():
    for name in READERS:
        assert cell.metric_reader(name)(_ctx(_stretch(), dropped=1)) is None


def test_site_readers_need_every_marked_replays_marks():
    recs = _stretch()
    recs[4] = _replay(2, 20.2, 39.2, marked=True, marks=False)
    ctx = _ctx(recs)
    assert cell.metric_reader("device_ms.decode")(ctx) == pytest.approx(17.0)
    assert cell.metric_reader("site_ms.decode")(ctx) is None
    assert cell.metric_reader("site_epilogue_ms.decode")(ctx) is None


def test_one_replay_has_no_wait():
    ctx = _ctx([_replay(1, 0.0, 17.0)])
    assert cell.metric_reader("host_wait_ms.step")(ctx) is None
    assert cell.metric_reader("device_ms.decode")(ctx) == pytest.approx(17.0)
    # no marked replay: no site reading, and none that is 0
    assert cell.metric_reader("site_ms.decode")(ctx) is None
    assert cell.metric_reader("site_epilogue_ms.decode")(ctx) is None


def test_device_time_reads_only_the_unmarked_graph():
    marked_only = [r for r in _stretch() if r.get("marked", True)]
    assert cell.metric_reader("device_ms.decode")(_ctx(marked_only)) is None


def test_the_table_names_every_site_and_phase():
    lines = program_trace.table(_ctx(_stretch()).program)
    text = "\n".join(lines)
    assert "attn_qkv" in text and "mlp_in" in text and "lost" in text
    assert "head 2.0000 ms" in text
    assert "17.0000 ms an unmarked replay (2), 19.0000 ms a marked" in text


def test_the_stretch_on_the_cpu_holds_no_device_record():
    """Served on a tiny program without graphs, the stretch holds the host
    spans and no device record, leaves tracing off, and every reader
    reports nothing."""
    from repro_torch.obs import trace

    spec = tiny_spec("nemotron4_15b")
    prog = cell.Program(spec.config, spec.traffic,
                        weights.make(spec.config, SEED, "cpu"), "cpu")
    out = program_trace.stretch(prog, spec, SEED, 0)
    names = {r["name"] for r in out["records"]}
    assert {"compiled_step.decode", "serve.greedy_to_host"} <= names
    assert out["dropped"] == 0 and not trace.is_enabled()
    assert not any("dev_t0" in r for r in out["records"])
    ctx = types.SimpleNamespace(program=out)
    for name in READERS:
        assert cell.metric_reader(name)(ctx) is None, name


def test_a_run_without_the_stretch_reads_nothing():
    ctx = types.SimpleNamespace()
    for name in READERS:
        assert cell.metric_reader(name)(ctx) is None, name
