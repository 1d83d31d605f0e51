"""Host-side spans — one clock discipline for every wall-clock number.

The port of `repro.obs.trace`. `span("serve_step", exec_path=...)` measures
host wall time with `time.perf_counter` (monotonic — never `time.time`,
which steps under NTP), optionally synchronizing the device of a tensor at
close so the measurement covers device execution, and opens a
`torch.profiler.record_function` range (plus an NVTX range once CUDA is
initialised) so device traces line up with host spans when a
`--profile-dir` window is open. Spans nest (each records its parent) and
carry the current correlation ids from :mod:`repro_torch.obs.events`, so
they join against sensor rows and journal decisions.

Disabled (the default), `span()` returns ONE shared no-op context manager
and records nothing: the disabled path is a dict lookup and a constant
return, no allocation.

A span never opens inside a CUDA graph capture: `sync` synchronizes the
device, which a capture refuses. The serve wraps the compiled step's call
in its span, so a step that captures closes its span after the capture.

Every record carries `t0` and `t1` (`perf_counter` seconds) beside `dur_s`.
`drain_spans()` returns the records and how many the cap dropped, so a
reader can refuse a stretch that lost some. A traced serve step on the card
leaves five records (`serve_step`, `compiled_step.decode`, its `.replay`
device record, `obs.resolve`, `serve.greedy_to_host`), so the cap holds
about 52,000 steps between drains; `dropped()` counts what it turned away.

The device timeline, without a profiler and without a sync: the compiled
step brackets each graph replay with two timing events from a reused pool
(`device_begin` / `device_end`), inside its host span. A pair is resolved
lazily, once its end event has completed (at a later call, or at drain),
into a device record: `dev_t0` / `dev_t1` on the host's clock, mapped
through one anchor (an event and the `perf_counter` reading taken when it
completed; set again at each `enable()`), and `parent_id` = the host
span; its `dur_s` is the pair's own elapsed time. Resolution runs inside an
`obs.resolve` span, so its host cost is on the record too.

Marks, asked for with `set_marks(True)` while tracing is on: while a
decode graph is captured with them (`capture_marks`), `mark(site, phase)`
records an external timing event (an event-record node of the graph): the
reuse engine marks each site call's entry (`phase` None) and the end of
its `quant`, `product` and `epilogue` phases, the decode step the LM
head's (`head`). A replay's marks are read into its device record as
(site, call ordinal, phase, ms) segments before the same graph replays
again; marks not ready by then are a dropped record. Each mark drains the
card's pipeline (~4 µs), so a marked replay runs longer than the unmarked
one: alternating the two (`set_marks` each step) times both.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any

import torch

now = time.perf_counter  # THE clock for wall-time measurements, repo-wide

_STATE: dict[str, Any] = {
    "enabled": False,
    "spans": [],          # completed span dicts, append order = close order
    "stack": [],          # open span ids (nesting)
    "next_id": 1,
    "max_spans": 262_144,  # hard cap: a runaway loop must not OOM the host
    "dropped": 0,         # records the cap (or a late read of marks) lost
}

_DEVICE: dict[str, Any] = {
    "anchor": None,       # (device, event, perf_counter when it completed)
    "pool": [],           # timing events free for reuse
    "pending": collections.deque(),  # replays not yet resolved, in order
    "marks": None,        # the capture's mark list while one records marks
    "marking": False,     # decode steps run their marked graph
}


def enable(*, max_spans: int | None = None) -> None:
    """Record spans, with the device clock's anchor taken anew (on a CUDA
    device already in use; else at the first replay)."""
    _STATE["enabled"] = True
    if max_spans is not None:
        _STATE["max_spans"] = int(max_spans)
    _DEVICE["anchor"] = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _anchor(torch.device("cuda", torch.cuda.current_device()))


def disable() -> None:
    """Stop recording; marks, if asked for, are asked for again after the
    next `enable()`."""
    _STATE["enabled"] = False
    _DEVICE["marking"] = False


def is_enabled() -> bool:
    return _STATE["enabled"]


def set_marks(on: bool) -> None:
    """Whether traced decode steps run the graph that holds the per-site
    marks (captured on its first such step) or the unmarked one. Each mark
    is an event-record node that drains the card's pipeline (a few
    microseconds), so marks are asked for, never implied by tracing."""
    _DEVICE["marking"] = on


def marking() -> bool:
    return _STATE["enabled"] and _DEVICE["marking"]


def dropped() -> int:
    """Records lost since the last drain (the cap, or marks read late)."""
    return _STATE["dropped"]


def spans() -> list[dict[str, Any]]:
    """Completed spans so far (the live buffer — do not mutate)."""
    return _STATE["spans"]


def drain_spans() -> tuple[list[dict[str, Any]], int]:
    """Resolve every pending replay (waiting for its end event), then return
    and clear the completed records and the count of records lost since
    the last drain."""
    resolve(wait=True)
    out, _STATE["spans"] = _STATE["spans"], []
    dropped, _STATE["dropped"] = _STATE["dropped"], 0
    return out, dropped


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in `value` (a tensor, or a tuple,
    list or dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def synchronize(value) -> None:
    """Wait for the devices that hold `value`'s tensors (the counterpart of
    `jax.block_until_ready`); host values and CPU tensors wait for
    nothing."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, value):
        return value

    def tag(self, **tags):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "tags", "span_id", "parent_id", "_t0", "_sync",
                 "_annotation", "_nvtx")

    def __init__(self, name: str, tags: dict[str, Any]):
        self.name = name
        self.tags = tags
        self.span_id = 0
        self.parent_id = 0
        self._t0 = 0.0
        self._sync = None
        self._annotation = None
        self._nvtx = False

    def sync(self, value):
        """Register a value whose device is synchronized at span close, so
        the span covers device execution, not just the launch. Returns the
        value."""
        self._sync = value
        return value

    def tag(self, **tags):
        """Attach tags discovered inside the span (e.g. tokens emitted)."""
        self.tags.update(tags)
        return self

    def __enter__(self):
        state = _STATE
        self.span_id = state["next_id"]
        state["next_id"] += 1
        stack = state["stack"]
        self.parent_id = stack[-1] if stack else 0
        stack.append(self.span_id)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            synchronize(self._sync)
        t1 = now()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._annotation.__exit__(*exc)
        state = _STATE
        stack = state["stack"]
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if len(state["spans"]) < state["max_spans"]:
            from repro_torch.obs.events import current_ids

            record = {
                "name": self.name,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "t0": self._t0,
                "t1": t1,
                "dur_s": t1 - self._t0,
                **self.tags,
            }
            ids = current_ids()
            if ids:
                record["trace"] = ids
            state["spans"].append(record)
        else:
            state["dropped"] += 1
        return False


def span(name: str, **tags: Any):
    """Open a measurement span. Usage:

        with span("serve_step", active=4) as sp:
            out = decode(...)
            sp.sync(out)        # synchronize out's device at close

    Disabled → the shared no-op (no allocation, no record)."""
    if not _STATE["enabled"]:
        return _NOOP
    return _Span(name, tags)


# ------------------------------------------------------ the device timeline

class _Replay:
    """One replay's event pair, pending until its end event completes."""

    __slots__ = ("name", "parent_id", "start", "end", "marks", "marked")

    def __init__(self, name, parent_id, start, end, marks):
        self.name, self.parent_id = name, parent_id
        self.start, self.end, self.marks = start, end, marks
        self.marked = marks is not None


def _event() -> "torch.cuda.Event":
    pool = _DEVICE["pool"]
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def _anchor(device: torch.device) -> tuple:
    """The anchor that maps `device`'s event times onto `perf_counter`: an
    event recorded on the idle device, and the host's reading once the
    event has completed (a few microseconds late at most)."""
    anchor = _DEVICE["anchor"]
    if anchor is None or anchor[0] != device:
        torch.cuda.synchronize(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        while not ev.query():
            pass
        anchor = _DEVICE["anchor"] = (device, ev, now())
    return anchor


def device_begin(device: torch.device) -> "torch.cuda.Event":
    """The start event of a replay, recorded on `device`'s current stream
    (call it just before the replay, after `before_replay`)."""
    _anchor(device)
    ev = _event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def device_end(device: torch.device, name: str, parent_id: int,
               start: "torch.cuda.Event", marks: list | None = None) -> None:
    """Record the end event just after the replay, and queue the pair (with
    the graph's `marks`, if it holds any) to be resolved later."""
    end = _event()
    end.record(torch.cuda.current_stream(device))
    _DEVICE["pending"].append(_Replay(name, parent_id, start, end, marks))


def before_replay(marks: list | None = None) -> None:
    """Before a replay is launched: resolve the pending replays that have
    completed (in a closed loop the card is idle here: the same reading
    beside a running replay slowed it). A pending replay of the graph about
    to replay, which holds `marks`, that has not completed has its marks
    counted as a dropped record (never guessed; its event pair is still
    resolved later)."""
    resolve()
    if marks is None:
        return
    for p in _DEVICE["pending"]:
        if p.marks is marks:
            p.marks = None
            _STATE["dropped"] += 1


def resolve(*, wait: bool = False) -> None:
    """Turn the pending replays whose end event has completed (every one,
    waiting, with `wait`) into device records, inside an `obs.resolve`
    span."""
    pending = _DEVICE["pending"]
    if not pending:
        return
    with span("obs.resolve"):
        while pending:
            p = pending[0]
            if not p.end.query():
                if not wait:
                    break
                p.end.synchronize()
            pending.popleft()
            _finish(p)


def _finish(p: _Replay) -> None:
    if len(_STATE["spans"]) < _STATE["max_spans"]:
        _STATE["spans"].append(_device_record(p))
    else:
        _STATE["dropped"] += 1
    _DEVICE["pool"] += (p.start, p.end)


def _device_record(p: _Replay) -> dict[str, Any]:
    _, anchor, host = _DEVICE["anchor"]
    t0 = host + anchor.elapsed_time(p.start) / 1e3
    t1 = host + anchor.elapsed_time(p.end) / 1e3
    span_id = _STATE["next_id"]
    _STATE["next_id"] += 1
    record = {"name": p.name, "span_id": span_id, "parent_id": p.parent_id,
              "dev_t0": t0, "dev_t1": t1,
              "dur_s": p.start.elapsed_time(p.end) / 1e3,
              "marked": p.marked}
    if p.marks is not None:
        record["marks"] = mark_segments(p.start, p.marks)
    return record


def mark_segments(start, marks: list) -> list[list]:
    """A replay's marks as [site, call ordinal, phase, ms] segments: each
    mark that ends a phase (`phase` not None) closes the segment since the
    mark before it; a site's calls count from 0 in capture order (its
    layer, unsharded)."""
    out, calls = [], {}
    elapsed = start.elapsed_time
    last = 0.0
    for site, phase, ev in marks:
        t = elapsed(ev)
        if phase is None:
            calls[site] = calls.get(site, -1) + 1
        elif site in calls:
            out.append([site, calls[site], phase, t - last])
        last = t
    return out


@contextlib.contextmanager
def capture_marks():
    """Inside the capture of a decode graph: `mark` calls record external
    timing events into the list this yields, in capture order."""
    marks = _DEVICE["marks"] = []
    try:
        yield marks
    finally:
        _DEVICE["marks"] = None


def mark(site: str, phase: str | None) -> None:
    """Record a timing event on the current stream: the entry of a call of
    `site` (`phase` None), or the end of its phase `phase`. Does nothing
    outside `capture_marks()` (one dict lookup)."""
    marks = _DEVICE["marks"]
    if marks is None:
        return
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    marks.append((site, phase, ev))


# ------------------------------------------------------ device-trace windows

TRACE_FILE = "trace.json"

_PROFILE: dict[str, Any] = {"dir": None, "prof": None}


def start_profile(log_dir: str) -> bool:
    """Open a `torch.profiler.profile` window (CPU activity, and CUDA
    activity when a card is present) whose Chrome trace `stop_profile`
    writes to `log_dir/trace.json`. Host spans emitted inside the window
    line up with the device trace through their `record_function` ranges.
    Returns False when the profiler cannot start (the serve run proceeds
    unprofiled rather than dying)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:
        print(f"obs: torch profiler unavailable ({e}); continuing "
              "unprofiled")
        return False
    os.makedirs(log_dir, exist_ok=True)
    _PROFILE.update(dir=log_dir, prof=prof)
    return True


def stop_profile() -> str | None:
    """Close the open profiler window and write its Chrome trace, returning
    the trace file's path (or None when no window was open)."""
    log_dir, prof = _PROFILE["dir"], _PROFILE["prof"]
    _PROFILE.update(dir=None, prof=None)
    if log_dir is None:
        return None
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


def write_spans_jsonl(path: str, *, drain: bool = True) -> int:
    """Append the span buffer to a JSONL file (one span per row). Returns the
    number of rows written; with `drain` (default) the buffer is cleared."""
    rows = drain_spans()[0] if drain else list(spans())
    if not rows:
        return 0
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)
