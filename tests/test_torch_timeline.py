"""The port's own timeline of a serve step (`repro_torch.obs.trace`,
`serve/compiled_step.py`) on the CPU: span records with their start and
end, the count of lost records, the lazy resolution of replay event pairs
into device records (with stand-in events, as the CPU has none), the
per-site marks a decode step would record in a capture, and the compiled
step's spans. Nothing here needs JAX; the card's side is in
tests/test_torch_gpu.py (`-k timeline`)."""

import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import backend, ops
from repro_torch.models import init_params
from repro_torch.obs import events
from repro_torch.obs import trace
from repro_torch.serve.compiled_step import MARKED, CompiledStep
from repro_torch.serve.scheduler import ContinuousBatcher, Request
from repro_torch.serve.serve_step import (
    build_reuse_engine,
    greedy_sample,
    greedy_to_host,
    init_serve_state,
)

B = 2


def _reset():
    events.clear_ids()
    trace.disable()
    trace._DEVICE["pending"].clear()
    trace._DEVICE["pool"].clear()
    trace._DEVICE.update(anchor=None, marks=None, marking=False)
    trace.drain_spans()
    trace._STATE["max_spans"] = 262_144


@pytest.fixture(autouse=True)
def _clean_obs_state():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    cfg = get_config("qwen3-32b").reduced()
    return cfg, init_params(cfg, 0, device="cpu")


def _step(model, arch_cfg=None):
    cfg, params = model if arch_cfg is None else arch_cfg
    engine = build_reuse_engine(cfg, impl="cuda", block_k=64)
    state = init_serve_state(cfg, B, 24, device="cpu")
    return CompiledStep(params, cfg, state, batch=B, engine=engine,
                        rcache=engine.init_cache(B, device="cpu"),
                        graphs=False)


class FakeEvent:
    """A stand-in CUDA timing event at `t` ms on a device clock."""

    def __init__(self, t=0.0, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


def _pending(name, parent, t0, t1, marks=None, done=True):
    trace._DEVICE["pending"].append(trace._Replay(
        name, parent, FakeEvent(t0), FakeEvent(t1, done), marks))


# ---------------------------------------------------------------- spans

def test_span_records_carry_start_and_end_and_nest():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        with trace.span("inner2"):
            pass
    rows, dropped = trace.drain_spans()
    assert dropped == 0
    by = {r["name"]: r for r in rows}
    for r in rows:
        assert r["t0"] <= r["t1"]
        assert r["dur_s"] == pytest.approx(r["t1"] - r["t0"])
    out = by["outer"]
    for name in ("inner", "inner2"):
        assert by[name]["parent_id"] == out["span_id"]
        assert out["t0"] <= by[name]["t0"] <= by[name]["t1"] <= out["t1"]
    assert by["inner"]["t1"] <= by["inner2"]["t0"]


def test_drain_reports_dropped_records():
    trace.enable(max_spans=3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert trace.dropped() == 2
    rows, dropped = trace.drain_spans()
    assert len(rows) == 3 and dropped == 2
    assert trace.drain_spans() == ([], 0) and trace.dropped() == 0


def test_enable_takes_the_anchor_anew():
    """Each `enable()` drops the old anchor: device times are mapped
    through one taken at the start of the traced stretch (here, with no
    CUDA device in use, at the first replay)."""
    trace._DEVICE["anchor"] = ("dev", FakeEvent(0.0), 100.0)
    trace.enable()
    assert trace._DEVICE["anchor"] is None


# ------------------------------------------------------ the device timeline

def test_pending_replays_resolve_lazily_onto_the_host_clock():
    """A pair resolves once its end event has completed, mapped through the
    anchor (device ms → host seconds), under its host span, inside an
    `obs.resolve` span; an unfinished pair waits, in order, until drain."""
    trace.enable()
    trace._DEVICE["anchor"] = ("dev", FakeEvent(0.0), 100.0)
    _pending("compiled_step.decode.replay", 7, 2.0, 5.0)
    _pending("compiled_step.decode.replay", 9, 6.0, 10.0, done=False)
    trace.resolve()
    rows = trace.spans()
    dev = [r for r in rows if "dev_t0" in r]
    assert len(dev) == 1 and len(trace._DEVICE["pending"]) == 1
    assert dev[0]["parent_id"] == 7
    assert dev[0]["dev_t0"] == pytest.approx(100.002)
    assert dev[0]["dev_t1"] == pytest.approx(100.005)
    assert dev[0]["dur_s"] == pytest.approx(0.003)
    resolves = [r for r in rows if r["name"] == "obs.resolve"]
    assert len(resolves) == 1
    assert len(trace._DEVICE["pool"]) == 2  # the pair's events, for reuse
    rows, dropped = trace.drain_spans()     # waits for the second
    assert dropped == 0 and not trace._DEVICE["pending"]
    dev = [r for r in rows if "dev_t0" in r]
    assert [r["parent_id"] for r in dev] == [7, 9]
    assert dev[1]["dev_t1"] == pytest.approx(100.010)


def test_marks_become_segments_and_late_marks_are_dropped():
    """A replay's marks: one segment per phase a site call ends, counted by
    the site's call ordinal; the gap between calls belongs to none. Marks a
    graph is about to record over before they were read are a dropped
    record, never guessed; the pair itself still resolves."""
    trace.enable()
    trace._DEVICE["anchor"] = ("dev", FakeEvent(0.0), 0.0)
    marks = [(site, phase, FakeEvent(t)) for site, phase, t in [
        ("a", None, 1.0), ("a", "quant", 1.5), ("a", "product", 3.0),
        ("a", "epilogue", 3.25), ("b", None, 4.0), ("b", "quant", 4.5),
        ("b", "product", 5.0), ("b", "epilogue", 6.0), ("a", None, 7.0),
        ("a", "quant", 7.5), ("a", "product", 8.0), ("a", "epilogue", 8.5),
        ("head", None, 9.0), ("head", "head", 9.75)]]
    start = FakeEvent(0.5)
    segs = trace.mark_segments(start, marks)
    assert segs == [["a", 0, "quant", 0.5], ["a", 0, "product", 1.5],
                    ["a", 0, "epilogue", 0.25], ["b", 0, "quant", 0.5],
                    ["b", 0, "product", 0.5], ["b", 0, "epilogue", 1.0],
                    ["a", 1, "quant", 0.5], ["a", 1, "product", 0.5],
                    ["a", 1, "epilogue", 0.5], ["head", 0, "head", 0.75]]
    trace._DEVICE["pending"].append(trace._Replay(
        "r", 1, start, FakeEvent(10.0), marks))
    trace.resolve()
    rec = [r for r in trace.spans() if "dev_t0" in r][0]
    assert rec["marks"] == segs
    assert sum(s[3] for s in segs) <= rec["dev_t1"] * 1e3 - rec["dev_t0"] * 1e3
    # a replay still running when its graph is launched again
    trace._DEVICE["pending"].append(trace._Replay(
        "r", 2, FakeEvent(11.0), FakeEvent(20.0, done=False), marks))
    trace.before_replay(marks)
    rows, dropped = trace.drain_spans()
    late = [r for r in rows if r.get("parent_id") == 2 and "dev_t0" in r]
    assert dropped == 1 and len(late) == 1 and "marks" not in late[0]
    assert late[0]["marked"] and rec["marked"]


def test_before_a_replay_what_finished_is_resolved():
    """`before_replay` resolves every finished replay, of any graph, and
    leaves an unfinished one pending (its marks dropped only where it is
    the graph about to replay)."""
    trace.enable()
    trace._DEVICE["anchor"] = ("dev", FakeEvent(0.0), 0.0)
    marks = [("a", None, FakeEvent(1.0)), ("a", "quant", FakeEvent(2.0))]
    trace._DEVICE["pending"].append(trace._Replay(
        "mine", 2, FakeEvent(0.5), FakeEvent(3.0), marks))
    _pending("other", 1, 3.5, 4.0, done=False)
    trace.before_replay(marks)
    assert [p.name for p in trace._DEVICE["pending"]] == ["other"]
    mine = [r for r in trace.spans() if r["name"] == "mine"]
    assert mine[0]["marks"] == [["a", 0, "quant", 1.0]]
    assert trace.drain_spans()[1] == 0


def test_marks_are_asked_for():
    assert not trace.marking()
    trace.enable()
    assert not trace.marking()
    trace.set_marks(True)
    assert trace.marking()
    trace.disable()
    assert not trace.marking()
    trace.enable()
    assert not trace.marking()


def test_mark_outside_a_capture_creates_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a timing event was created")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    trace.enable()
    trace.mark("attn_qkv", None)
    trace.mark("attn_qkv", "quant")
    assert trace._DEVICE["marks"] is None


class RecordedEvent:
    """A stand-in for the capture's external timing events."""

    made = []

    def __init__(self, **kw):
        assert kw == {"enable_timing": True, "external": True}
        RecordedEvent.made.append(self)

    def record(self, stream=None):
        pass


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_a_decode_step_marks_every_site_call_and_the_head(monkeypatch, model,
                                                          arch):
    """The marks a decode step records inside `capture_marks`: every site
    once per layer, in order, each call as entry, quant, product,
    epilogue; then the head's pair; nothing outside the capture."""
    monkeypatch.setattr(torch.cuda, "Event", RecordedEvent)
    RecordedEvent.made = []
    if arch == "qwen3-32b":
        step = _step(model)
    else:
        cfg = get_config(arch).reduced()
        step = _step(None, (cfg, init_params(cfg, 0, device="cpu")))
    step.prefill(np.ones((B, 4), np.int32))
    step.decode(np.ones((B, 1), np.int32))
    assert RecordedEvent.made == []
    with torch.no_grad(), trace.capture_marks() as marks:
        step.run_decode()
    assert trace._DEVICE["marks"] is None
    assert [ev for _, _, ev in marks] == RecordedEvent.made
    labels = [(site, phase) for site, phase, _ in marks]
    assert labels[-2:] == [("head", None), ("head", "head")]
    calls = labels[:-2]
    assert len(calls) % 4 == 0
    per_site = collections.Counter()
    for i in range(0, len(calls), 4):
        site = calls[i][0]
        assert calls[i:i + 4] == [(site, None), (site, "quant"),
                                  (site, "product"), (site, "epilogue")]
        per_site[site] += 1
    assert set(per_site) == set(step.engine.sites)
    assert set(per_site.values()) == {step.cfg.n_superblocks}
    segs = trace.mark_segments(FakeEvent(0.0), [
        (s, p, FakeEvent(float(i))) for i, (s, p, _) in enumerate(marks)])
    assert len(segs) == 3 * len(calls) // 4 + 1


# ------------------------------------------------------ the compiled step

def _counting(monkeypatch):
    """The ops entry points count as their kernels would on the card."""
    names = {"delta_quant_account": lambda kw: "delta_quant_account",
             "reuse_matmul": lambda kw: f"reuse_matmul_{kw['dataflow']}"}
    for fn, kname in names.items():
        orig = getattr(ops, fn)

        def counting(*a, _orig=orig, _kname=kname, **kw):
            backend.count_launch(_kname(kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, fn, counting)


def test_tracing_leaves_the_key_launches_and_events_alone(monkeypatch, model):
    """Without graphs a traced decode, marks asked for, keys, launches and
    computes as an untraced one, and creates no timing event; the marked
    component is only ever added where graphs are captured."""
    def no_event(*a, **k):
        raise AssertionError("a timing event was created")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _counting(monkeypatch)
    runs = {}
    for traced in (False, True):
        if traced:
            trace.enable()
            trace.set_marks(True)
        backend.reset_launches()
        step = _step(model)
        step.prefill(np.ones((B, 4), np.int32))
        logits = [step.decode(np.full((B, 1), t, np.int32)).clone()
                  for t in range(3)]
        runs[traced] = (step.decode_key(), list(step.variants),
                        backend.launch_counts(), logits)
        trace.disable()
    backend.reset_launches()
    (k0, v0, c0, l0), (k1, v1, c1, l1) = runs[False], runs[True]
    assert k0 == k1 and v0 == v1 and c0 == c1
    assert c0["delta_quant_account"] > 0
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert MARKED not in k0 and all(MARKED not in k for k in v1)
    assert k0 + (MARKED,) == step.decode_key(marked=True)


def test_compiled_step_spans_without_graphs(model):
    """Under tracing, `prefill` and `decode` each record their host span
    (the variant's build too); without graphs there is no device record,
    and nothing is pending."""
    step = _step(model)
    trace.enable()
    step.prefill(np.ones((B, 4), np.int32))
    for t in range(3):
        step.decode(np.full((B, 1), t, np.int32))
    rows, dropped = trace.drain_spans()
    names = collections.Counter(r["name"] for r in rows)
    assert names == {"compiled_step.prefill": 1, "compiled_step.decode": 3}
    assert dropped == 0 and not any("dev_t0" in r for r in rows)
    assert not trace._DEVICE["pending"]


def test_greedy_to_host_is_the_copy_back():
    logits = torch.randn(3, 1, 50, generator=torch.Generator().manual_seed(1))
    want = greedy_sample(logits).cpu().numpy()
    got = greedy_to_host(logits)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    trace.enable()
    np.testing.assert_array_equal(greedy_to_host(logits), want)
    assert [r["name"] for r in trace.spans()] == ["serve.greedy_to_host"]


def test_scheduler_spans_record_without_syncs():
    """The batcher's prefill and serve_step spans, around callables that
    return host values: one a request and one a decode step."""
    trace.enable()

    def prefill_fn(prompt, slot):
        return int(prompt.sum()) % 7

    def decode_fn(tokens):
        return (np.asarray(tokens) + 1).astype(np.int32)

    batcher = ContinuousBatcher(batch_slots=B, prefill_fn=prefill_fn,
                                decode_fn=decode_fn, max_steps=32)
    for rid in range(3):
        batcher.submit(Request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                               max_new_tokens=3))
    done = batcher.run()
    rows, _ = trace.drain_spans()
    names = collections.Counter(r["name"] for r in rows)
    assert names["prefill"] == 3
    assert names["serve_step"] == batcher.stats["steps"] > 0
    assert all(len(r.output) == 3 for r in done)
    assert all(r["t0"] <= r["t1"] for r in rows)
