"""The result's line has exactly the contract's keys, "check" last, and
each per-layer reader reports a number or nothing, never a share over
100%."""

import json
import types

import pytest

from bench import cell
from bench.tests.helpers import BENCH, tiny_run

PER_LAYER = [p.stem for p in (BENCH / "metrics").glob("*.py")]


def test_end_to_end_line():
    res = tiny_run("nemotron4_15b", cohorts=2)
    line = cell.result_line(res, False, kind="cpu", count=1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"decode_tok_s", "itl_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["correct"] is True and line["attempted"] == 4
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line():
    res = tiny_run("rwkv6_7b", trace=True, cohorts=1, per_layer=PER_LAYER)
    line = cell.result_line(res, True, kind="cpu", count=1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the readers that need the device's trace report nothing
    assert {"host_ms.step", "tile_skip", "step_mfu"} <= set(line["metrics"])
    for name, m in line["metrics"].items():
        assert m["value"] >= 0
        if m["unit"] == "%":
            assert m["value"] <= 100, name
    assert "reuse_gemm_roofline" not in line["metrics"]


def test_busy_time_is_the_union_of_device_intervals():
    # µs; the second overlaps the first, the third nests in the second
    intervals = [(0, 10), (5, 20), (6, 8), (30, 40), (40, 45)]
    assert cell.union_seconds(intervals) == pytest.approx(35e-6)
    assert cell.union_seconds([]) == 0.0


def test_idle_share_is_not_clamped():
    read = cell.metric_reader("idle_share.device")
    assert read(types.SimpleNamespace(wall_s=1.0, busy_s=0.75)) == 25.0
    # a busy time counted above the wall reads out of range, to be caught
    assert read(types.SimpleNamespace(wall_s=1.0, busy_s=1.2)) < 0
