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
"""

from __future__ import annotations

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
    "dropped": 0,
}


def enable(*, max_spans: int | None = None) -> None:
    _STATE["enabled"] = True
    if max_spans is not None:
        _STATE["max_spans"] = int(max_spans)


def disable() -> None:
    _STATE["enabled"] = False


def is_enabled() -> bool:
    return _STATE["enabled"]


def spans() -> list[dict[str, Any]]:
    """Completed spans so far (the live buffer — do not mutate)."""
    return _STATE["spans"]


def drain_spans() -> list[dict[str, Any]]:
    """Return and clear the completed-span buffer."""
    out, _STATE["spans"] = _STATE["spans"], []
    _STATE["dropped"] = 0
    return out


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
        dur = now() - self._t0
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
                "dur_s": dur,
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
    rows = drain_spans() if drain else list(spans())
    if not rows:
        return 0
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)
