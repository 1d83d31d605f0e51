"""Tailing JSONL readers — one replica's obs dir as an incremental stream.

The port of `repro.obs.stream`, a copy.

A serving replica emits four JSONL families into its obs dir while it runs
(`sensor.jsonl` cumulative counter rows, `spans.jsonl` measured wall-clock,
`journal.jsonl` control/guard decisions, `metrics.jsonl` registry snapshots).
The fleet plane must consume them *while the replica is still writing*, so
:func:`tail_jsonl` reads incrementally from a byte cursor and holds back an
incomplete final line (a row the replica is mid-append on) instead of failing
on it — the same crash-tolerance contract `repro_torch.control.report.load_journal`
practices at rest:

* a line without a trailing newline is NOT consumed — the next poll retries
  it once the writer finishes (or the final poll counts it as torn);
* on the FINAL poll (`final=True`, the replica is known dead) a leftover
  partial or unparseable last line is forgiven and counted in
  ``TailCursor.torn`` — a replica that died mid-append still aggregates;
* an unparseable line with rows AFTER it is mid-file corruption and raises —
  silently skipping interior rows would corrupt fleet rollups.

:class:`ReplicaStream` bundles one cursor per family for a replica obs dir
(the layout ``serve --obs-dir`` and ``launch/replicas.py`` write) and is the
unit :class:`repro_torch.obs.fleet.FleetAggregator` merges.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

# family name -> file inside a replica obs dir. `sensor` and `journal` match
# the serve flags (--sensor-jsonl / --control-journal) the replica harness
# points into the obs dir; `spans`/`metrics` are the --obs-dir exports.
STREAM_FAMILIES: dict[str, str] = {
    "sensor": "sensor.jsonl",
    "spans": "spans.jsonl",
    "journal": "journal.jsonl",
    "metrics": "metrics.jsonl",
}


@dataclasses.dataclass
class TailCursor:
    """Progress through one JSONL file: consumed bytes + torn-line count."""

    offset: int = 0
    rows: int = 0
    torn: int = 0


def tail_jsonl(path: str, cursor: TailCursor, *,
               final: bool = False) -> list[dict[str, Any]]:
    """Read rows appended to `path` since `cursor.offset`.

    Consumes only newline-terminated lines; a partial final line stays
    unconsumed for the next poll. With `final=True` (the writer is known
    finished) a leftover partial — or an unparseable last line — is counted
    as torn and skipped rather than raised: the one-torn-tail forgiveness of
    `load_journal`, applied to a live tail. Unparseable rows with data after
    them raise `ValueError` (real mid-file corruption)."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        f.seek(cursor.offset)
        data = f.read()
    if not data:
        return []
    end = data.rfind(b"\n")
    complete, partial = (b"", data) if end < 0 else (
        data[: end + 1], data[end + 1:])
    rows: list[dict[str, Any]] = []
    lines = complete.splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError as e:
            if final and i == len(lines) - 1 and not partial.strip():
                cursor.torn += 1  # newline-terminated torn tail: forgiven
                continue
            raise ValueError(
                f"{path}: unparseable row before the tail at byte "
                f"{cursor.offset} (mid-file corruption, not a torn append): "
                f"{e}") from e
    cursor.offset += len(complete)
    if final and partial.strip():
        cursor.torn += 1  # writer died mid-append: forgiven, counted
        cursor.offset += len(partial)
    cursor.rows += len(rows)
    return rows


class ReplicaStream:
    """One replica's obs dir as four incrementally-tailed row streams.

    `replica` defaults to the dir basename with a ``replica-`` prefix
    stripped (the `launch/replicas.py` layout). Rows stamped with a
    conflicting ``trace.replica`` id raise — a mislabeled stream must not
    silently pollute another replica's rollups."""

    def __init__(self, obs_dir: str, *, replica: str | None = None):
        self.obs_dir = obs_dir
        base = os.path.basename(os.path.normpath(obs_dir))
        if replica is None:
            replica = base[len("replica-"):] if base.startswith("replica-") \
                else base
        self.replica = replica
        self._cursors = {fam: TailCursor() for fam in STREAM_FAMILIES}

    def __repr__(self) -> str:
        return f"ReplicaStream({self.replica!r}, {self.obs_dir!r})"

    @property
    def torn_lines(self) -> int:
        return sum(c.torn for c in self._cursors.values())

    @property
    def rows_consumed(self) -> int:
        return sum(c.rows for c in self._cursors.values())

    def cursor(self, family: str) -> TailCursor:
        return self._cursors[family]

    def poll(self, *, final: bool = False) -> dict[str, list[dict[str, Any]]]:
        """New rows per family since the last poll. Verifies any stamped
        replica id matches this stream's identity."""
        out: dict[str, list[dict[str, Any]]] = {}
        for fam, fname in STREAM_FAMILIES.items():
            rows = tail_jsonl(
                os.path.join(self.obs_dir, fname), self._cursors[fam],
                final=final)
            for row in rows:
                stamped = (row.get("trace") or {}).get("replica")
                if stamped is not None and str(stamped) != str(self.replica):
                    raise ValueError(
                        f"{self.obs_dir}/{fname}: row stamped "
                        f"replica={stamped!r} inside replica "
                        f"{self.replica!r}'s stream")
            out[fam] = rows
        return out


def discover_replica_streams(fleet_dir: str) -> list[ReplicaStream]:
    """Replica streams under a fleet dir: every subdirectory holding at least
    one known stream family file (`replica-*` naming not required)."""
    streams = []
    for name in sorted(os.listdir(fleet_dir)):
        sub = os.path.join(fleet_dir, name)
        if not os.path.isdir(sub):
            continue
        if any(os.path.exists(os.path.join(sub, f))
               for f in STREAM_FAMILIES.values()):
            streams.append(ReplicaStream(sub))
    return streams
