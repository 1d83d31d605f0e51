"""Correlation ids — the join keys of the unified event stream.

A serve run emits record families (sensor rows, and in the reference also
control-journal rows and obs spans) that are stamped with the SAME id set,
so a run can be joined offline:

    replica  — fleet identity of the emitting replica
    run      — one id per process-lifetime observation scope (a serve run)
    session  — the session the active request belongs to
    request  — the request id being prefilled/retired
    window   — the controller interval the record falls in
    site / layer — which reuse site (and ctrl lane) a record concerns

Ids live in module state (the serving loop is single-threaded host Python;
the step never reads them). `stamp(row)` returns the row with a ``"trace"``
sub-dict of the current ids — and returns it UNCHANGED when no ids are set,
so consumers that never set ids emit rows byte-identical to the reference's
`repro.obs.events`, of which this module is a copy.
"""

from __future__ import annotations

import contextlib
import uuid
from typing import Any

_IDS: dict[str, Any] = {}


def new_run_id() -> str:
    """A fresh run-scope id (short uuid — unique per serve/bench process)."""
    return uuid.uuid4().hex[:12]


def set_ids(**ids: Any) -> None:
    """Set correlation ids for subsequent stamps. `None` values clear keys."""
    for key, val in ids.items():
        if val is None:
            _IDS.pop(key, None)
        else:
            _IDS[key] = val


def clear_ids(*keys: str) -> None:
    """Clear the named ids, or ALL ids when called with no arguments."""
    if not keys:
        _IDS.clear()
        return
    for key in keys:
        _IDS.pop(key, None)


def current_ids() -> dict[str, Any]:
    return dict(_IDS)


@contextlib.contextmanager
def context(**ids: Any):
    """Scoped ids: set for the block, restore the previous values after —
    nesting-safe (an inner request context restores the outer window id)."""
    saved = {key: _IDS.get(key, _MISSING) for key in ids}
    set_ids(**ids)
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is _MISSING:
                _IDS.pop(key, None)
            else:
                _IDS[key] = val


_MISSING = object()


def stamp(row: dict[str, Any]) -> dict[str, Any]:
    """Return `row` with the current correlation ids under ``"trace"``.

    With no ids set the row is returned UNCHANGED."""
    if not _IDS:
        return row
    return dict(row, trace=dict(_IDS))
