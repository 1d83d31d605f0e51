"""Metrics export — Prometheus textfile + JSONL snapshots.

The port of `repro.obs.export`, a copy: both packages write and parse the
same text, line for line.

Two sinks, one registry:

* `write_prometheus(path, registry)` — the node-exporter textfile-collector
  format: `# TYPE` headers, `name{label="v"} value` samples; histograms emit
  `_count`/`_sum` plus `{quantile="0.5|0.95|0.99"}` summary samples.
* `write_jsonl(path, registry)` — appends one snapshot row per metric,
  stamped with the current correlation ids and a shared `snap` sequence
  number so `repro_torch.obs.top` (and offline joins) can group rows per snapshot.

`parse_prometheus` is the inverse of the textfile writer — the round-trip
contract the exporter tests lock.
"""

from __future__ import annotations

import json
import re
from typing import Any

from repro_torch.obs.events import stamp
from repro_torch.obs.metrics import MetricsRegistry

_SNAP_SEQ = {"n": 0}

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label_value(value: str) -> str:
    """Exposition-format label escaping: backslash, double-quote, newline.
    Raw interpolation corrupts the textfile — a value containing `"` closes
    the label early and a newline splits the sample across lines."""
    return (value.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


def _unescape_label_value(value: str) -> str:
    """Exact inverse of `_escape_label_value`."""
    out: list[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, ch + nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _prom_labels(labels: dict[str, Any], extra: dict[str, Any] | None = None
                 ) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{_escape_label_value(str(v))}"'
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def prometheus_lines(registry: MetricsRegistry) -> list[str]:
    lines: list[str] = []
    seen_types: set[str] = set()
    for row in registry.snapshot():
        name = _prom_name(row["name"])
        kind = row["type"]
        if kind == "histogram":
            # summary-style emission: quantiles + _count/_sum
            if name not in seen_types:
                lines.append(f"# TYPE {name} summary")
                seen_types.add(name)
            for q in (50, 95, 99):
                lines.append(
                    f"{name}{_prom_labels(row['labels'], {'quantile': q / 100})}"
                    f" {row[f'p{q}']:.9g}")
            lines.append(
                f"{name}_count{_prom_labels(row['labels'])} {row['count']}")
            lines.append(
                f"{name}_sum{_prom_labels(row['labels'])} {row['sum']:.9g}")
        else:
            prom_kind = "counter" if kind == "counter" else "gauge"
            if name not in seen_types:
                lines.append(f"# TYPE {name} {prom_kind}")
                seen_types.add(name)
            lines.append(
                f"{name}{_prom_labels(row['labels'])} {row['value']:.9g}")
    return lines


def write_prometheus(path: str, registry: MetricsRegistry) -> int:
    lines = prometheus_lines(registry)
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


def parse_labels(body: str) -> dict[str, str]:
    """Parse the inside of a `{...}` label set, exact inverse of
    `_prom_labels`: quote/escape-aware, so values containing `}`, `,`, `"`
    (escaped) or newlines (escaped) round-trip."""
    labels: dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        if body[i] == ",":
            i += 1
            continue
        eq = body.find("=", i)
        if eq < 0 or eq + 1 >= n or body[eq + 1] != '"':
            raise ValueError(f"bad label pair at {body[i:]!r}")
        key = body[i:eq].strip()
        j = eq + 2  # scan the quoted value, honouring backslash escapes
        raw: list[str] = []
        while j < n and body[j] != '"':
            if body[j] == "\\" and j + 1 < n:
                raw.append(body[j:j + 2])
                j += 2
            else:
                raw.append(body[j])
                j += 1
        if j >= n:
            raise ValueError(f"unterminated label value in {body!r}")
        labels[key] = _unescape_label_value("".join(raw))
        i = j + 1
    return labels


def _split_sample(line: str) -> tuple[str, str, str]:
    """Split a sample line into (name, label_body, value) with a
    quote-aware scan — a regex that stops at the first `}` mis-parses any
    label value containing `}` or an escaped quote."""
    m = re.match(r"^([a-zA-Z0-9_:]+)", line)
    if m is None:
        raise ValueError(f"not a prometheus sample: {line!r}")
    name = m.group(1)
    rest = line[m.end():]
    body = ""
    if rest.startswith("{"):
        i, n = 1, len(rest)
        while i < n and rest[i] != "}":
            if rest[i] == '"':  # skip the quoted value
                i += 1
                while i < n and rest[i] != '"':
                    i += 2 if rest[i] == "\\" else 1
            i += 1
        if i >= n:
            raise ValueError(f"unterminated label set: {line!r}")
        body = rest[1:i]
        rest = rest[i + 1:]
    value = rest.strip()
    if not value or any(c.isspace() for c in value):
        raise ValueError(f"not a prometheus sample: {line!r}")
    return name, body, value


def parse_prometheus(text: str) -> dict[str, dict[str, float]]:
    """Inverse of the textfile writer: {metric_name: {label_string: value}}.
    Label strings are re-serialised canonically (sorted keys, escaped
    values — `_prom_labels` form), so writer output keys itself. `# TYPE`
    lines are validated (they must precede their samples)."""
    out: dict[str, dict[str, float]] = {}
    typed: set[str] = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                typed.add(parts[2])
            continue
        try:
            name, body, value = _split_sample(line)
            labels = parse_labels(body)
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}") from e
        base = name[:-6] if name.endswith("_count") else (
            name[:-4] if name.endswith("_sum") else name)
        if base not in typed:
            raise ValueError(f"line {lineno}: sample {name!r} precedes its "
                             f"# TYPE header")
        out.setdefault(name, {})[_prom_labels(labels)] = float(value)
    return out


def write_jsonl(path: str, registry: MetricsRegistry, *,
                extra: dict[str, Any] | None = None) -> int:
    """Append one snapshot (one row per metric) to a JSONL file. Rows share a
    `snap` sequence number and carry the current correlation ids."""
    _SNAP_SEQ["n"] += 1
    snap = _SNAP_SEQ["n"]
    rows = registry.snapshot()
    with open(path, "a") as f:
        for row in rows:
            row = dict(row, snap=snap)
            if extra:
                row.update(extra)
            f.write(json.dumps(stamp(row)) + "\n")
    return len(rows)


def load_snapshots(path: str) -> list[list[dict[str, Any]]]:
    """Parse a metrics JSONL back into snapshots (grouped by `snap`)."""
    by_snap: dict[int, list[dict[str, Any]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            by_snap.setdefault(int(row.get("snap", 0)), []).append(row)
    return [by_snap[k] for k in sorted(by_snap)]
