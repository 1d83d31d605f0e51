"""Host-side reduction of sensor counters into a SensorReport.

``build_report(engine, cache)`` copies each site's counters to the host once
and reduces them per (site, layer), per site (layers summed) and for the
whole model; ``slot_telemetry`` reads one serving slot's hit-rate lanes at
request retirement. ``SensorReport.write_jsonl`` appends one JSON object per
row — the serving emission format the tuning loop reads
(`repro_torch.tune.trace`). Same rows, fields, summary lines and JSONL rows
as `repro.sensor.aggregate`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.policy import mode_name
from repro_torch.core.reuse_cache import resolve_exec_path
from repro_torch.sensor.counters import COUNTER_SHARD_REDUCE

# Version stamped on every emitted JSONL row (the reference's; the trace
# loaders of both packages refuse rows they don't understand). v6 rows carry
# schema_version, site geometry, grid_steps, exec_path, overflow_fallbacks,
# per-layer modes with budget_occupancy, and sentinel_trips.
SENSOR_SCHEMA_VERSION = 6


@dataclasses.dataclass
class SiteSensor:
    """Measured counters for one reuse site (optionally one layer of it)."""

    site: str
    layer: int | None
    mode: str
    steps: int
    skipped_tiles: int
    computed_tiles: int
    skipped_macs: float
    computed_macs: float
    skipped_weight_bytes: float
    total_weight_bytes: float
    reused_out_elems: float
    dma_issued_tiles: int
    mode_transitions: int
    slot_hit_rates: list[float]
    slot_steps: list[int]
    suppressed_flips: int = 0
    grid_steps: float = 0.0
    overflow_fallbacks: int = 0
    exec_path: str = "auto"
    budget_occupancy: float = 0.0
    sentinel_trips: int = 0
    in_features: int = 0
    out_features: int = 0
    block_m: int = 0
    block_k: int = 0
    block_n: int = 0

    @property
    def total_tiles(self) -> int:
        return self.skipped_tiles + self.computed_tiles

    @property
    def tile_skip_rate(self) -> float:
        return self.skipped_tiles / max(self.total_tiles, 1)

    @property
    def total_macs(self) -> float:
        return self.skipped_macs + self.computed_macs

    @property
    def mac_skip_rate(self) -> float:
        return self.skipped_macs / max(self.total_macs, 1e-9)

    @property
    def weight_byte_skip_rate(self) -> float:
        return self.skipped_weight_bytes / max(self.total_weight_bytes, 1e-9)

    @property
    def dense_grid_steps(self) -> float:
        gn = -(-self.out_features // self.block_n) if self.block_n else 0
        return float(self.total_tiles * gn)

    @property
    def grid_step_skip_rate(self) -> float:
        dense = self.dense_grid_steps
        if dense <= 0:
            return 0.0
        return max(0.0, 1.0 - self.grid_steps / dense)

    @property
    def hit_rate(self) -> float:
        """Mean per-slot hit rate over active lanes (slot_steps > 0)."""
        active = [r for r, s in zip(self.slot_hit_rates, self.slot_steps) if s > 0]
        return float(np.mean(active)) if active else 0.0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(
            total_tiles=self.total_tiles,
            tile_skip_rate=self.tile_skip_rate,
            total_macs=self.total_macs,
            mac_skip_rate=self.mac_skip_rate,
            weight_byte_skip_rate=self.weight_byte_skip_rate,
            grid_step_skip_rate=self.grid_step_skip_rate,
            hit_rate=self.hit_rate,
        )
        return d


@dataclasses.dataclass
class SensorReport:
    per_site: list[SiteSensor]
    per_layer: list[SiteSensor]
    model: dict[str, Any]

    def summary_lines(self) -> list[str]:
        lines = [
            "SensorReport model: "
            f"steps={self.model['steps']} "
            f"mac_skip={self.model['mac_skip_rate']:.1%} "
            f"weight_byte_skip={self.model['weight_byte_skip_rate']:.1%} "
            f"tile_skip={self.model['tile_skip_rate']:.1%} "
            f"grid_step_skip={self.model.get('grid_step_skip_rate', 0.0):.1%} "
            f"hit_rate={self.model['hit_rate']:.3f}"
        ]
        for s in self.per_site:
            lines.append(
                f"  {s.site:24s} mode={s.mode:5s} exec={s.exec_path:7s} "
                f"steps={s.steps:4d} "
                f"tile_skip={s.tile_skip_rate:6.1%} "
                f"mac_skip={s.mac_skip_rate:6.1%} "
                f"grid_skip={s.grid_step_skip_rate:6.1%} "
                f"hit={s.hit_rate:.3f} transitions={s.mode_transitions} "
                f"suppressed={s.suppressed_flips} ovf={s.overflow_fallbacks}"
            )
        return lines

    def to_dicts(self) -> list[dict[str, Any]]:
        """The model row, then the site rows, then the layer rows, each with
        its kind and the schema version, stamped with the correlation ids
        when any are set (`repro_torch.obs.events`)."""
        from repro_torch.obs.events import stamp

        ver = {"schema_version": SENSOR_SCHEMA_VERSION}
        rows = [dict(self.model, kind="model", **ver)]
        rows += [dict(s.to_dict(), kind="site", **ver) for s in self.per_site]
        rows += [dict(s.to_dict(), kind="layer", **ver) for s in self.per_layer]
        return [stamp(row) for row in rows]

    def write_jsonl(self, path: str, *, mode: str = "a") -> None:
        with open(path, mode) as f:
            for row in self.to_dicts():
                f.write(json.dumps(row) + "\n")


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _entry_rows(name: str, entry: dict, spec=None,
                impl: str = "cuda") -> list[SiteSensor]:
    """One SiteSensor per leading-layer slice of a cache entry's counters;
    each layer row carries that layer's kernelMode."""
    sensor = {k: _host(v) for k, v in entry["sensor"].items()}
    stacked = sensor["skipped_tiles"].ndim >= 1
    n_layers = sensor["skipped_tiles"].shape[0] if stacked else 1

    def leaf(key, layer):
        a = sensor[key]
        return a[layer] if stacked else a

    ctrl = entry.get("ctrl")
    if ctrl is not None:
        mode_ids = np.atleast_1d(_host(ctrl["mode_id"]))
        occupancy = np.atleast_1d(_host(ctrl["occupancy"]).astype(np.float64))
    else:
        mode_ids = np.full((n_layers,), -1)
        occupancy = np.zeros((n_layers,))
    steps = _host(entry["steps"])
    rows = []
    for layer in range(n_layers):
        hit_sum = np.asarray(leaf("slot_hit_sum", layer), np.float64)
        slot_steps = np.asarray(leaf("slot_steps", layer), np.int64)
        rows.append(SiteSensor(
            site=name,
            layer=layer if stacked else None,
            mode=(mode_name(mode_ids[layer])
                  if mode_ids[layer] >= 0 else "auto"),
            steps=int(steps[layer] if stacked and steps.ndim else np.max(steps)),
            skipped_tiles=int(leaf("skipped_tiles", layer)),
            computed_tiles=int(leaf("computed_tiles", layer)),
            skipped_macs=float(leaf("skipped_macs", layer)),
            computed_macs=float(leaf("computed_macs", layer)),
            skipped_weight_bytes=float(leaf("skipped_weight_bytes", layer)),
            total_weight_bytes=float(leaf("total_weight_bytes", layer)),
            reused_out_elems=float(leaf("reused_out_elems", layer)),
            dma_issued_tiles=int(leaf("dma_issued_tiles", layer)),
            mode_transitions=int(leaf("mode_transitions", layer)),
            slot_hit_rates=list(hit_sum / np.maximum(slot_steps, 1)),
            slot_steps=[int(s) for s in slot_steps],
            suppressed_flips=int(leaf("suppressed_flips", layer)),
            grid_steps=float(leaf("grid_steps", layer)),
            overflow_fallbacks=int(leaf("overflow_fallbacks", layer)),
            sentinel_trips=int(leaf("sentinel_trips", layer)),
            exec_path=resolve_exec_path(spec, impl) if spec else "auto",
            budget_occupancy=float(occupancy[layer]),
            in_features=spec.in_features if spec else 0,
            out_features=spec.out_features if spec else 0,
            block_m=spec.block_m if spec else 0,
            block_k=spec.block_k if spec else 0,
            block_n=spec.block_n if spec else 0,
        ))
    return rows


def collapse_shard_sensor(sensor: dict, axis: int) -> dict[str, np.ndarray]:
    """Host copies of a model-sharded site's counters (and "steps", if
    present) with the shard axis `axis` collapsed per
    `COUNTER_SHARD_REDUCE`: ownership-partition lanes sum (the unsharded
    counter, bitwise), replicated lanes take shard 0."""
    out = {}
    for key, arr in sensor.items():
        a = _host(arr)
        red = COUNTER_SHARD_REDUCE.get(key, "first")
        out[key] = a.sum(axis=axis) if red == "sum" else np.take(a, 0,
                                                                  axis=axis)
    return out


def _collapse_shard_entry(entry: dict, axis: int) -> dict:
    """A model-sharded entry's shard axis collapsed on the host, BEFORE the
    row builder (whose leading-axis reading must keep meaning "layers"):
    counters per `collapse_shard_sensor`; ctrl and steps are replicated
    across shards, so lane 0. Returns the host entry the row builder
    reads (sensor, ctrl, steps)."""
    out: dict[str, Any] = {
        "sensor": collapse_shard_sensor(entry["sensor"], axis),
        "steps": np.take(_host(entry["steps"]), 0, axis=axis),
    }
    ctrl = entry.get("ctrl")
    if ctrl is not None:
        out["ctrl"] = {k: np.take(_host(v), 0, axis=axis)
                       for k, v in ctrl.items()}
    return out


def _sum_rows(name: str, rows: list[SiteSensor]) -> SiteSensor:
    hit = np.mean([r.slot_hit_rates for r in rows], axis=0)
    lane_steps = np.max([r.slot_steps for r in rows], axis=0)
    modes = {r.mode for r in rows}
    return SiteSensor(
        site=name,
        layer=None,
        mode=modes.pop() if len(modes) == 1 else "mixed",
        steps=max(r.steps for r in rows),
        skipped_tiles=sum(r.skipped_tiles for r in rows),
        computed_tiles=sum(r.computed_tiles for r in rows),
        skipped_macs=sum(r.skipped_macs for r in rows),
        computed_macs=sum(r.computed_macs for r in rows),
        skipped_weight_bytes=sum(r.skipped_weight_bytes for r in rows),
        total_weight_bytes=sum(r.total_weight_bytes for r in rows),
        reused_out_elems=sum(r.reused_out_elems for r in rows),
        dma_issued_tiles=sum(r.dma_issued_tiles for r in rows),
        mode_transitions=sum(r.mode_transitions for r in rows),
        slot_hit_rates=list(np.asarray(hit, np.float64)),
        slot_steps=[int(s) for s in lane_steps],
        # suppression is a site-level event bumped on every layer at once
        suppressed_flips=max(r.suppressed_flips for r in rows),
        grid_steps=sum(r.grid_steps for r in rows),
        overflow_fallbacks=sum(r.overflow_fallbacks for r in rows),
        sentinel_trips=sum(r.sentinel_trips for r in rows),
        exec_path=rows[0].exec_path,
        budget_occupancy=float(np.mean([r.budget_occupancy for r in rows])),
        in_features=rows[0].in_features,
        out_features=rows[0].out_features,
        block_m=rows[0].block_m,
        block_k=rows[0].block_k,
        block_n=rows[0].block_n,
    )


def build_report(engine, cache: dict[str, Any]) -> SensorReport:
    """Reduce a reuse cache's sensor counters (`engine` supplies the specs;
    model-sharded sites are collapsed first, and the model row of a sharded
    engine carries the mesh and interconnect keys)."""
    per_site, per_layer = [], []
    if getattr(engine, "placement", None) is not None:
        # one shard a card: the counters of every shard, on the host, in
        # the one-device layout (one collective)
        cache = engine.host_cache(cache)
    impl = getattr(engine, "impl", "cuda")
    shards = getattr(engine, "shards", None) or {}
    stacking = getattr(engine, "stacking", None) or {}
    for name in engine.sites:
        entry = cache[name]
        if "sensor" not in entry:
            continue
        if name in shards:
            entry = _collapse_shard_entry(
                entry, 1 if stacking.get(name, 0) else 0)
        rows = _entry_rows(name, entry, spec=engine.sites[name], impl=impl)
        if rows[0].layer is not None:
            per_layer += rows
        per_site.append(_sum_rows(name, rows))
    tot = {
        k: sum(getattr(s, k) for s in per_site)
        for k in ("skipped_tiles", "computed_tiles", "skipped_macs",
                  "computed_macs", "skipped_weight_bytes", "total_weight_bytes",
                  "reused_out_elems", "mode_transitions", "suppressed_flips",
                  "grid_steps", "overflow_fallbacks", "sentinel_trips")
    }
    total_tiles = tot["skipped_tiles"] + tot["computed_tiles"]
    total_macs = tot["skipped_macs"] + tot["computed_macs"]
    dense_grid = sum(s.dense_grid_steps for s in per_site)
    model = dict(
        tot,
        steps=max((s.steps for s in per_site), default=0),
        n_sites=len(per_site),
        total_tiles=total_tiles,
        tile_skip_rate=tot["skipped_tiles"] / max(total_tiles, 1),
        total_macs=total_macs,
        mac_skip_rate=tot["skipped_macs"] / max(total_macs, 1e-9),
        weight_byte_skip_rate=(
            tot["skipped_weight_bytes"] / max(tot["total_weight_bytes"], 1e-9)
        ),
        grid_step_skip_rate=max(
            0.0, 1.0 - tot["grid_steps"] / max(dense_grid, 1e-9)
        ),
        hit_rate=float(np.mean([s.hit_rate for s in per_site])) if per_site else 0.0,
    )
    if shards:
        # mesh provenance and interconnect payloads for the E_ICI pricing:
        # keys only sharded runs carry (unsharded rows are unchanged)
        model["mesh_model_shards"] = max(shards.values())
        model["ici_reduce_bytes"] = float(
            getattr(engine, "ici_reduce_bytes", 0.0))
        model["ici_ctrl_write_bytes"] = float(
            getattr(engine, "ici_write_bytes", 0.0))
    return SensorReport(per_site=per_site, per_layer=per_layer, model=model)


def slot_telemetry(engine, cache: dict[str, Any], slot: int) -> dict[str, Any]:
    """Per-request telemetry for one serving slot, read at retirement: only
    the slot's per-site hit-rate lanes (placed: every shard's, in the
    one-device layout)."""
    if getattr(engine, "placement", None) is not None:
        cache = engine.host_cache(cache, keys=("sensor",))
    hit_sums, steps = [], 0
    for name in engine.sites:
        sensor = cache[name].get("sensor")
        if sensor is None:
            continue
        hs = _host(sensor["slot_hit_sum"][..., slot]).astype(np.float64)
        ss = _host(sensor["slot_steps"][..., slot]).astype(np.float64)
        hit_sums.append(float(np.sum(hs) / max(float(np.sum(ss)), 1.0))
                        if np.sum(ss) else 0.0)
        steps = max(steps, int(np.max(ss)))
    return {
        "slot": slot,
        "steps": steps,
        "hit_rate": float(np.mean(hit_sums)) if hit_sums else 0.0,
        "n_sites": len(hit_sums),
    }
