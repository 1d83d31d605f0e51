"""Sensor-trace loader — parses `--sensor-jsonl` output for the fitter.

A sensor trace is the JSONL file the serve CLI (`--sensor-jsonl`) and the
measured-decode runner append
:class:`~repro_torch.sensor.aggregate.SensorReport` rows to (the same rows
as the reference's, so a trace of either package loads in the other's
loader; this module is the port of `repro.tune.trace`). Counters are
cumulative, and a long-running server appends a report per emission, so for
each site the LAST row wins — it covers the whole measured window.

The loader is strict about provenance: every row must carry the
``schema_version`` this tree emits (`SENSOR_SCHEMA_VERSION`). Traces recorded
by older builds (no version field, or no site geometry) are refused with a
:class:`TraceSchemaError` rather than silently mis-fitted — the fitter's
bookkeeping model needs the geometry fields that only versioned rows carry.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.sensor.aggregate import SENSOR_SCHEMA_VERSION


class TraceSchemaError(ValueError):
    """Raised when a trace row is missing/mismatched on schema_version or
    lacks the fields the fitter needs."""


@dataclasses.dataclass(frozen=True)
class SiteTraceRecord:
    """One site's measured operating point over the trace window (or one
    LAYER's slice of a stacked site, when `layer` is set — layer rows carry
    the same counters at per-layer granularity)."""

    site: str
    mode: str
    steps: int
    batch: int                 # serving lanes (len of slot_steps)
    in_features: int
    out_features: int
    block_m: int
    block_k: int
    block_n: int
    tile_skip_rate: float
    mac_skip_rate: float
    weight_byte_skip_rate: float
    hit_rate: float
    mode_transitions: int
    suppressed_flips: int
    total_weight_bytes: float
    total_macs: float
    # Schema-v3 fields: the execution substrate the site ran on and the
    # measured grid-step walk (dense baseline = total_tiles · gn).
    exec_path: str = "auto"
    grid_steps: float = 0.0
    grid_step_skip_rate: float = 0.0
    # Schema-v4 field: evaluations whose live tile count overflowed the
    # compacted-path budget (the reference's full-extent fallback).
    overflow_fallbacks: int = 0
    # Schema-v5 fields: which layer of a stacked site this row slices
    # (None = whole site) and the ctrl block's live-tile-fraction EMA.
    layer: int | None = None
    budget_occupancy: float = 0.0

    @property
    def work_flops(self) -> float:
        """Dense per-row work of the site (the policy's min_work metric)."""
        return 2.0 * self.in_features * self.out_features

    @property
    def harvest_efficiency(self) -> float:
        """Measured skip-per-similarity ratio: how much of the stream's code
        similarity the current block_k actually converts into skipped weight
        traffic. 1.0 = every similar code lands in a fully-skipped tile."""
        if self.hit_rate <= 0.0:
            return 0.0
        return min(self.weight_byte_skip_rate / self.hit_rate, 1.0)


@dataclasses.dataclass(frozen=True)
class Trace:
    """Parsed trace: last snapshot per site (and per layer) + the last
    model-level row."""

    sites: dict[str, SiteTraceRecord]
    model: dict[str, Any] | None
    n_rows: int
    path: str
    # {site: {layer: record}} from "layer" rows — stacked sites' per-layer
    # operating points, which the fitter turns into "site@layer" tunables
    # rows. Empty for traces recorded from unstacked engines.
    layers: dict[str, dict[int, SiteTraceRecord]] = dataclasses.field(
        default_factory=dict
    )


_REQUIRED_SITE_FIELDS = (
    "site", "mode", "steps", "in_features", "out_features",
    "block_m", "block_k", "block_n", "tile_skip_rate", "mac_skip_rate",
    "weight_byte_skip_rate", "hit_rate", "slot_steps",
)


# v2-v5 rows lack only fields this loader defaults (grid_steps + exec_path on
# v2, overflow_fallbacks on v2/v3, budget_occupancy below v5, sentinel_trips
# below v6), so they stay loadable; v1 (unversioned) rows lack the geometry
# and are refused.
SUPPORTED_SCHEMA_VERSIONS = (2, 3, 4, 5, SENSOR_SCHEMA_VERSION)


def _check_version(row: dict[str, Any], lineno: int, path: str) -> None:
    ver = row.get("schema_version")
    if ver is None:
        raise TraceSchemaError(
            f"{path}:{lineno}: row has no schema_version — trace predates the "
            f"versioned emission; re-record with --sensor-jsonl on this build"
        )
    if ver not in SUPPORTED_SCHEMA_VERSIONS:
        raise TraceSchemaError(
            f"{path}:{lineno}: schema_version {ver} not in supported "
            f"{SUPPORTED_SCHEMA_VERSIONS}"
        )


def _site_record(row: dict[str, Any], lineno: int, path: str) -> SiteTraceRecord:
    missing = [f for f in _REQUIRED_SITE_FIELDS if f not in row]
    if missing:
        raise TraceSchemaError(f"{path}:{lineno}: site row missing {missing}")
    # The fitter divides by every one of these; zero means the row was
    # recorded without real site specs.
    zeroed = [f for f in ("in_features", "out_features", "block_m", "block_k")
              if not row[f]]
    if zeroed or not row["slot_steps"]:
        raise TraceSchemaError(
            f"{path}:{lineno}: site row carries no geometry "
            f"({zeroed or ['slot_steps']} empty) — recorded by an engine "
            f"without specs?"
        )
    return SiteTraceRecord(
        site=row["site"],
        mode=row["mode"],
        steps=int(row["steps"]),
        batch=len(row["slot_steps"]),
        in_features=int(row["in_features"]),
        out_features=int(row["out_features"]),
        block_m=int(row["block_m"]),
        block_k=int(row["block_k"]),
        block_n=int(row["block_n"]),
        tile_skip_rate=float(row["tile_skip_rate"]),
        mac_skip_rate=float(row["mac_skip_rate"]),
        weight_byte_skip_rate=float(row["weight_byte_skip_rate"]),
        hit_rate=float(row["hit_rate"]),
        mode_transitions=int(row.get("mode_transitions", 0)),
        suppressed_flips=int(row.get("suppressed_flips", 0)),
        total_weight_bytes=float(row.get("total_weight_bytes", 0.0)),
        total_macs=float(row.get("total_macs", 0.0)),
        exec_path=str(row.get("exec_path", "auto")),
        grid_steps=float(row.get("grid_steps", 0.0)),
        grid_step_skip_rate=float(row.get("grid_step_skip_rate", 0.0)),
        overflow_fallbacks=int(row.get("overflow_fallbacks", 0)),
        layer=row["layer"] if isinstance(row.get("layer"), int) else None,
        budget_occupancy=float(row.get("budget_occupancy", 0.0)),
    )


def load_trace(path: str) -> Trace:
    """Parse a sensor JSONL trace; last row per site wins (cumulative
    counters). Raises TraceSchemaError on version/field mismatch."""
    sites: dict[str, SiteTraceRecord] = {}
    layers: dict[str, dict[int, SiteTraceRecord]] = {}
    model: dict[str, Any] | None = None
    n_rows = 0
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceSchemaError(f"{path}:{lineno}: not JSON ({e})") from e
            _check_version(row, lineno, path)
            n_rows += 1
            kind = row.get("kind")
            if kind == "site":
                rec = _site_record(row, lineno, path)
                sites[rec.site] = rec
            elif kind == "layer":
                # stacked sites' per-layer slices — the per-layer fitter's
                # input (last row per (site, layer) wins, like site rows)
                rec = _site_record(row, lineno, path)
                if rec.layer is not None:
                    layers.setdefault(rec.site, {})[rec.layer] = rec
            elif kind == "model":
                model = row
    if not sites:
        raise TraceSchemaError(f"{path}: no site rows found")
    return Trace(sites=sites, model=model, n_rows=n_rows, path=path,
                 layers=layers)
