"""Control-plane decisions: typed records, per-interval reports, JSONL journal.

The port of `repro.control.report`, whole: the same schema (v5), kinds,
fields, row layout and torn-tail tolerance, so a journal written by either
package loads in the other's `load_journal`.

Every knob the controller moves is recorded as a :class:`Decision` — what
changed, from what to what, and the measured evidence it acted on — and every
`Controller.step` emits a :class:`ControlReport` (the interval's windows,
decisions, and the sites whose compiled step must rebuild). The
:class:`DecisionJournal` appends both to a JSONL file so an adaptive serving
run can be audited or replayed offline: the journal plus the sensor trace is
the complete causal record of why the policy is where it is.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

#   1 — the first emission
#   2 — decision rows carry `layer` (per-layer ctrl-lane retunes and
#       per-layer kernelMode flips of stacked sites; null = site-granular)
#   3 — rows carry obs correlation ids under "trace" when the obs plane is
#       active (run/window/...; absent = pre-obs emission, byte-identical to
#       v2), and the "restore" decision kind records checkpoint-vs-tuned-table
#       precedence resolutions at startup
#   4 — the "quarantine" decision kind records guard-plane containment
#       transitions (field="state": active→quarantined→probation→active, with
#       the tripped-sentinel evidence in `reason`; field="stall_windows":
#       straggler-watchdog events, site=""), and `load_journal` tolerates
#       exactly one torn final row (crash mid-append) by emitting a
#       kind="torn_tail" marker instead of raising
#   5 — decision rows carry `shard` (model-axis shard the decision is scoped
#       to; null = mesh-global, which every pre-sharding decision is — v1-v4
#       rows load with shard=None) and the "shard" decision kind records
#       per-shard observations from the windowed cross-mesh counter reduce
#       (field="skip_rate": one row per shard whose window moved; the GLOBAL
#       controller trajectory stays shard=None, so a journal shows per-shard
#       skip truth alongside ONE global knob stream)
CONTROL_JOURNAL_SCHEMA_VERSION = 5
LOADABLE_JOURNAL_VERSIONS = (1, 2, 3, 4, 5)

# Decision kinds: which feedback loop acted.
#   "retune"  — online refit of a SiteTunables knob from windowed counters
#               (layer set = a "site@layer" ctrl-lane row, no retrace)
#   "budget"  — max_active_k widened/tightened from the overflow-fallback rate
#   "mode"    — kernelMode flip applied by the hysteretic refresh (an array
#               write into the ctrl block; layer set for stacked sites)
#   "exec"    — execution-substrate flip applied by the hysteretic refresh
#   "admit"   — admission-predictor population estimate moved
#   "restore" — startup precedence resolution between a checkpointed ctrl
#               block and the tuned-policy table (checkpoint < table < live)
#   "quarantine" — guard-plane containment: a tripped sentinel pinned a lane
#               to basic/dense, a lockout drained into probation, or a lane
#               re-admitted after clean windows (field="state"); straggler
#               stalls journal as field="stall_windows" with site=""
#   "shard"   — per-shard observation from the once-per-window cross-mesh
#               counter reduce (field="skip_rate"; `shard` set). Moves no
#               knob — replay chains it for audit but applies nothing.
DECISION_KINDS = (
    "retune", "budget", "mode", "exec", "admit", "restore", "quarantine",
    "shard")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One knob the controller moved, with its evidence."""

    step: int            # serving decode step the interval closed at
    site: str            # "" for model-level (admission) decisions
    kind: str
    field: str           # tunable/spec field that moved (e.g. "sim_threshold")
    before: Any
    after: Any
    reason: str          # measured evidence, human-readable
    # Which layer of a stacked site the decision targets (per-layer ctrl-lane
    # writes: "site@layer" retune rows, per-layer mode flips). None =
    # site-granular (spec-level knobs, unstacked sites).
    layer: int | None = None
    # Which model-axis shard the decision is scoped to. None = mesh-global:
    # every knob the controller moves is global (tunables/modes/budgets write
    # replicated ctrl lanes), so only kind="shard" observation rows set this.
    shard: int | None = None

    def __post_init__(self) -> None:
        if self.kind not in DECISION_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {DECISION_KINDS}")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ControlReport:
    """What one controller interval saw and did."""

    step: int                       # decode step the interval closed at
    interval: int                   # 1-based controller invocation count
    window_steps: dict[str, int]    # per-site evaluations in this window
    decisions: list[Decision]
    # sites whose spec changed this interval (the reference rebuilds its
    # jitted step exactly when this is non-empty; the port's compiled step
    # picks its variant by key at the next decode)
    retrace: dict[str, str]
    admission: dict[str, Any] | None = None  # predictor snapshot, if attached

    @property
    def changed(self) -> bool:
        return bool(self.retrace)

    def summary_lines(self) -> list[str]:
        lines = [
            f"ControlReport step={self.step} interval={self.interval} "
            f"windows={len(self.window_steps)} decisions={len(self.decisions)} "
            f"retrace={sorted(self.retrace) or '-'}"
        ]
        for d in self.decisions:
            where = d.site or "<model>"
            if d.layer is not None:
                where = f"{where}@{d.layer}"
            if d.shard is not None:
                where = f"{where}#s{d.shard}"
            lines.append(
                f"  {d.kind:6s} {where:24s} "
                f"{d.field}: {d.before} -> {d.after}  ({d.reason})"
            )
        return lines

    def to_dicts(self) -> list[dict[str, Any]]:
        """JSONL rows: one interval row + one row per decision. Rows are
        stamped with the current obs correlation ids (no-op when the obs
        plane is inactive — the v2 byte layout is preserved exactly)."""
        from repro_torch.obs.events import stamp

        ver = {"schema_version": CONTROL_JOURNAL_SCHEMA_VERSION}
        ts = time.time()
        rows = [dict(
            kind="interval", step=self.step, interval=self.interval,
            window_steps=self.window_steps, n_decisions=len(self.decisions),
            retrace=self.retrace, admission=self.admission, ts=ts, **ver,
        )]
        rows += [dict(d.to_dict(), kind="decision", decision_kind=d.kind,
                      interval=self.interval, ts=ts, **ver)
                 for d in self.decisions]
        return [stamp(row) for row in rows]


class DecisionJournal:
    """Append-only JSONL audit log of controller activity."""

    def __init__(self, path: str):
        self.path = path
        self.rows_written = 0

    def append(self, report: ControlReport) -> None:
        # crash consistency: serialize the whole interval first, then ONE
        # write + flush. A crash can tear at most the final OS-level write —
        # never interleave half an interval with the next process's rows —
        # and load_journal tolerates exactly that one torn tail.
        rows = report.to_dicts()
        payload = "".join(json.dumps(row) + "\n" for row in rows)
        with open(self.path, "a") as f:
            f.write(payload)
            f.flush()
        self.rows_written += len(rows)

    def note(self, **fields: Any) -> None:
        """Append one kind="note" row outside any ControlReport: operational
        facts that belong in the audit stream but move no knob — e.g. an
        interpret-measured latency table fed to a compiled-mode run. Loaders
        keep notes (load_journal accepts any kind); replay ignores them (it
        only chains kind="decision" rows)."""
        from repro_torch.obs.events import stamp

        row = stamp(dict(
            kind="note", ts=time.time(),
            schema_version=CONTROL_JOURNAL_SCHEMA_VERSION, **fields,
        ))
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
            f.flush()
        self.rows_written += 1


def load_journal(path: str) -> list[dict[str, Any]]:
    """Parse a decision journal back into rows (audit/replay).

    Loads every journal version this repo has ever emitted
    (`LOADABLE_JOURNAL_VERSIONS`): v1 rows gain `layer=None`, v1/v2 rows
    simply lack the v3 `trace` id sub-dict — consumers treat both as
    optional. Unknown FUTURE versions are rejected loudly.

    Crash tolerance (v4): `DecisionJournal.append` writes whole intervals in
    one flushed write, so the only tear a crash can produce is a truncated
    FINAL line. Exactly that is forgiven — the bad tail is replaced by a
    ``{"kind": "torn_tail", "lineno": ..., "prefix": ...}`` marker row
    (replay-inert: replay only chains kind="decision" rows) so the audit
    stream records that the run died mid-append. Unparseable rows anywhere
    BEFORE the tail are still real corruption and raise."""
    with open(path) as f:
        lines = f.readlines()
    numbered = [(i, ln.strip()) for i, ln in enumerate(lines, start=1)
                if ln.strip()]
    rows: list[dict[str, Any]] = []
    for pos, (lineno, line) in enumerate(numbered):
        try:
            row = json.loads(line)
        except json.JSONDecodeError as e:
            if pos == len(numbered) - 1:
                rows.append({
                    "kind": "torn_tail", "lineno": lineno,
                    "prefix": line[:80],
                    "schema_version": CONTROL_JOURNAL_SCHEMA_VERSION,
                })
                return rows
            raise ValueError(
                f"{path}:{lineno}: unparseable journal row before the tail "
                f"(mid-file corruption, not a torn append): {e}") from e
        ver = row.get("schema_version")
        if ver not in LOADABLE_JOURNAL_VERSIONS:
            raise ValueError(
                f"{path}:{lineno}: journal schema_version {ver!r} not in "
                f"{LOADABLE_JOURNAL_VERSIONS}")
        if row.get("kind") == "decision":
            if "layer" not in row:
                row["layer"] = None  # v1 decisions predate per-layer lanes
            if "shard" not in row:
                row["shard"] = None  # v1-v4 decisions predate the mesh
        rows.append(row)
    return rows
