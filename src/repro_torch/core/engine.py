"""ReuseEngine — site registry, dispatch and the host-side policy passes.

* `register(...)` declares a reuse site (sites of the layer stack carry a
  leading [L] axis in their cache);
* `init_cache(batch, device)` builds the cache: per site the tensors of
  `reuse_cache.init_site_cache`, broadcast to [L] with per-layer tunables
  rows in the ctrl lanes, plus the host mirror of the mode ids;
* `layer_view(cache, l)` hands layer l views of its lane (updates through
  them land in the stacked tensors);
* `apply(...)` executes one site (the crs call), reading kernelMode from the
  host mirror;
* `refresh_modes(cache)` / `refresh_exec_paths(cache)` are the host passes
  between steps, fed by ONE device→host transfer (`ctrl_snapshot`); mode
  flips are writes to the ctrl lane and its mirror, exec-path flips are
  spec changes and are returned.

Unsharded only: the reference's model-axis sharding, its ICI accounting and
the guard plane's sentinel lanes come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.policy import (
    MODE_BASIC,
    MODE_REUSE,
    ReusePolicy,
    SiteTunables,
    layer_key,
    mode_name,
)
from repro_torch.core.reuse_cache import (
    ReuseSiteSpec,
    init_site_cache,
    map_tensors,
    resolve_exec_path,
)
from repro_torch.core.reuse_linear import ReuseStats, reuse_linear
from repro_torch.kernels.ops import clamp_budget

# ctrl_snapshot lanes, in the order they are packed per site
_SNAP_LANES = ("sim_l", "mode_id", "sim_threshold", "min_work", "cooldown",
               "quarantine")
_SNAP_DTYPES = {"sim_l": np.float32, "mode_id": np.int8,
                "sim_threshold": np.float32, "min_work": np.float32,
                "cooldown": np.int32, "quarantine": np.int32}


def lane_mean(sim: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (the batch lanes), rounded as the reference's
    compiled `jnp.mean(sim, axis=-1)` on the CPU: the M lanes are cut into
    ceil(M / 32) windows of ceil(M / windows) lanes, each window is summed
    in lane order, the window sums are added in order, and the total is
    multiplied by f32(1 / M). Every step is an elementwise f32 add, so the
    bits are the same on the CPU and on the card. Matches the reference for
    every M <= 64 and for M = 32j and 32j - 1 up to 256; other widths round
    differently (ROADMAP, Queue 3)."""
    m = sim.shape[-1]
    win = -(-m // -(-m // 32))
    total = None
    for start in range(0, m, win):
        acc = sim[..., start]
        for j in range(start + 1, min(start + win, m)):
            acc = acc + sim[..., j]
        total = acc if total is None else total + acc
    return total * float(np.float32(1.0 / m))


@dataclasses.dataclass
class ReuseEngine:
    policy: ReusePolicy = dataclasses.field(default_factory=ReusePolicy)
    impl: str = "cuda"
    sites: dict[str, ReuseSiteSpec] = dataclasses.field(default_factory=dict)
    stacking: dict[str, int] = dataclasses.field(default_factory=dict)
    exec_cooldown: dict[str, int] = dataclasses.field(default_factory=dict)
    last_mode_events: list[dict] = dataclasses.field(default_factory=list)
    last_snapshot: dict[str, Any] | None = None

    def register(
        self,
        name: str,
        in_features: int,
        out_features: int,
        *,
        n_layers: int = 0,
        block_m: int = 8,
        block_k: int = 256,
        block_n: int = 128,
        mode: str = "auto",
    ) -> ReuseSiteSpec:
        dataflow = self.policy.decide_dataflow(in_features, out_features)
        block_k = self.policy.resolve_block_k(name, block_k)
        spec = ReuseSiteSpec(
            name=name,
            in_features=in_features,
            out_features=out_features,
            block_m=block_m,
            block_k=block_k,
            block_n=block_n,
            mode=mode,
            dataflow=dataflow,
            exec_path=self.policy.resolve_exec_path(name),
            max_active_k=self.policy.resolve_max_active_k(name),
        )
        self.sites[name] = spec
        self.stacking[name] = n_layers
        self.exec_cooldown[name] = 0
        return spec

    def init_cache(self, batch: int, *, device="cuda") -> dict[str, Any]:
        cache: dict[str, Any] = {}
        for name, spec in self.sites.items():
            entry = init_site_cache(spec, batch, self.policy.resolve(name),
                                    device=device)
            n_layers = self.stacking[name]
            if n_layers:
                entry = map_tensors(
                    lambda x: (x.expand(n_layers, *x.shape).clone()
                               if isinstance(x, torch.Tensor)
                               else np.repeat(x[None], n_layers, axis=0)),
                    entry,
                )
                ts = [self.policy.resolve(name, layer=layer)
                      for layer in range(n_layers)]
                entry["ctrl"]["sim_threshold"] = torch.tensor(
                    [t.sim_threshold for t in ts], dtype=torch.float32,
                    device=device)
                entry["ctrl"]["min_work"] = torch.tensor(
                    [t.min_work_flops for t in ts], dtype=torch.float32,
                    device=device)
            cache[name] = entry
        return cache

    @staticmethod
    def layer_view(cache: dict[str, Any], layer: int) -> dict[str, Any]:
        """Every site's lane `layer`, as views into the stacked cache."""
        return {name: map_tensors(lambda x: x[layer], entry)
                for name, entry in cache.items()}

    def apply(
        self,
        name: str,
        x: torch.Tensor,
        w: torch.Tensor,
        b: torch.Tensor | None,
        cache_entry: dict[str, Any],
    ) -> tuple[torch.Tensor, dict[str, Any], ReuseStats]:
        spec = self.sites[name]
        # pinned sites keep a static branch; "auto" sites read the mirror
        mode = spec.mode if spec.mode in ("reuse", "basic") else None
        return reuse_linear(x, w, b, cache_entry, spec, mode=mode,
                            impl=self.impl)

    # ------------------------------------------------------- kernelMode writes

    @staticmethod
    def _write_modes(entry: dict[str, Any], mode_ids: np.ndarray) -> None:
        """Write a site's mode ids to the device lane and its host mirror."""
        new = np.asarray(mode_ids, np.int8).reshape(entry["mode_host"].shape)
        entry["ctrl"]["mode_id"].copy_(torch.from_numpy(new.copy()))
        entry["mode_host"][...] = new

    def set_mode(
        self, cache: dict[str, Any], name: str, mode: str,
        *, layer: int | None = None,
    ) -> None:
        """Force kernelMode for a site (all layers, or one layer's lane)."""
        mid = MODE_REUSE if mode == "reuse" else MODE_BASIC
        entry = cache[name]
        new = np.array(entry["mode_host"], np.int8)
        if layer is None:
            new[...] = mid
        else:
            new[layer] = mid
        self._write_modes(entry, new)

    # ------------------------------------------------------- live write paths

    def apply_tunables(
        self,
        name: str,
        t: SiteTunables,
        cache: dict[str, Any] | None = None,
        *,
        layer: int | None = None,
    ) -> bool:
        """Install live tunables. `layer=None` replaces the site row and
        re-resolves the spec fields it bakes in (block_k; the budget of a site
        already on a compacted path); `layer=i` installs a per-layer row and
        touches no spec field. With `cache`, the ctrl sim_threshold/min_work
        lanes re-sync. Returns True when the spec changed."""
        if layer is not None:
            self.policy.site_tunables[layer_key(name, layer)] = t
            self._sync_ctrl(name, cache)
            return False
        self.policy.site_tunables[name] = t
        spec = self.sites[name]
        new = spec
        if t.block_k is not None and int(t.block_k) != spec.block_k:
            new = dataclasses.replace(new, block_k=int(t.block_k))
            if new.exec_path in ("ragged", "compact") and new.max_active_k:
                # rescale the budget so the covered K extent survives the
                # granularity change, and sync the table entry to it
                gk = -(-new.in_features // new.block_k)
                scaled = round(new.max_active_k * spec.block_k / new.block_k)
                new = dataclasses.replace(
                    new, max_active_k=clamp_budget(int(scaled), gk))
                self.policy.site_tunables[name] = dataclasses.replace(
                    t, max_active_k=new.max_active_k)
        if (
            t.max_active_k is not None
            and new.exec_path in ("ragged", "compact")
            and spec.block_k == new.block_k
            and int(t.max_active_k) != new.max_active_k
        ):
            gk = -(-new.in_features // new.block_k)
            new = dataclasses.replace(
                new, max_active_k=clamp_budget(int(t.max_active_k), gk))
        self._sync_ctrl(name, cache)
        if new == spec:
            return False
        self.sites[name] = new
        return True

    def _sync_ctrl(self, name: str, cache: dict[str, Any] | None) -> None:
        """Re-derive a site's ctrl sim_threshold/min_work lanes from the
        policy table (per-layer rows win over the site row)."""
        if cache is None or name not in cache or "ctrl" not in cache[name]:
            return
        ctrl = cache[name]["ctrl"]
        n_layers = self.stacking.get(name, 0)
        ts = ([self.policy.resolve(name, layer=i) for i in range(n_layers)]
              if n_layers else [self.policy.resolve(name)])
        thr = torch.tensor([t.sim_threshold for t in ts], dtype=torch.float32)
        mw = torch.tensor([t.min_work_flops for t in ts], dtype=torch.float32)
        ctrl["sim_threshold"].copy_(thr.reshape(ctrl["sim_threshold"].shape))
        ctrl["min_work"].copy_(mw.reshape(ctrl["min_work"].shape))

    # -------------------------------------------------- host-side policy pass

    def ctrl_snapshot(self, cache: dict[str, Any]) -> dict[str, Any]:
        """Everything the host passes read, for ALL sites, in ONE device→host
        transfer: per-layer sim_ema means, the ctrl lanes and the sensor tile
        sums are packed on the device into one f64 vector (every value is
        exact in f64) and copied once."""
        parts: list[torch.Tensor] = []
        layout: list[tuple[str, str, int]] = []
        for name, entry in cache.items():
            ctrl = entry.get("ctrl")
            if ctrl is not None:
                sim = entry["sim_ema"]
                lanes = {
                    "sim_l": sim if sim.ndim == 0 else lane_mean(sim),
                    **{k: ctrl[k] for k in _SNAP_LANES[1:]},
                }
                for key in _SNAP_LANES:
                    v = lanes[key].reshape(-1)
                    parts.append(v.double())
                    layout.append((name, key, v.numel()))
            sensor = entry.get("sensor")
            if sensor is not None:
                for key, src in (("skipped", "skipped_tiles"),
                                 ("computed", "computed_tiles")):
                    parts.append(sensor[src].sum().double().reshape(1))
                    layout.append((name, key, 0))
        flat = torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
        snap: dict[str, Any] = {name: {} for name in cache}
        pos = 0
        for name, key, count in layout:
            if count == 0:  # a scalar sum
                snap[name][key] = int(flat[pos])
                pos += 1
            else:
                snap[name][key] = flat[pos:pos + count].astype(
                    _SNAP_DTYPES[key])
                pos += count
        self.last_snapshot = snap
        return snap

    def refresh_modes(self, cache: dict[str, Any]) -> dict[str, str]:
        """Host policy pass: one batched per-layer decide per site (hysteresis
        band, per-lane cooldown), mode writes to the ctrl lanes and their
        mirror; then `refresh_exec_paths` on the same snapshot. Returns
        {site: "exec:<path>"} for the exec-path flips (spec changes)."""
        self.last_mode_events = []
        snap = self.ctrl_snapshot(cache)
        for name, spec in self.sites.items():
            entry = cache[name]
            ctrl = entry.get("ctrl")
            if ctrl is None:
                continue
            s = snap[name]
            sim_l = np.asarray(s["sim_l"], np.float64)
            mode_id = np.asarray(s["mode_id"])
            n_lanes = mode_id.shape[0]
            if sim_l.shape[0] != n_lanes:
                sim_l = np.broadcast_to(sim_l, (n_lanes,))
            thr = np.asarray(s["sim_threshold"], np.float64)
            mw = np.asarray(s["min_work"], np.float64)
            cd = np.asarray(s["cooldown"], np.int64)
            stacked = self.stacking.get(name, 0) > 0
            ts = [self.policy.resolve(name, layer=layer if stacked else None)
                  for layer in range(n_lanes)]
            margin = np.asarray([t.hysteresis_margin for t in ts])
            hyst = np.asarray([t.hysteresis_steps for t in ts])
            want = self.policy.decide_modes(
                spec, sim_l, mode_id, thr, mw, hysteresis_margin=margin,
                quarantine=np.asarray(s["quarantine"]),
            )
            flip = want != mode_id
            vetoed = flip & (cd > 0)
            applied = flip & ~vetoed
            new_mode = np.where(applied, want, mode_id)
            new_cd = np.where(applied, hyst, np.maximum(cd - 1, 0))
            if vetoed.any() and "sensor" in entry:
                entry["sensor"]["suppressed_flips"].add_(1)
            for lane in np.nonzero(applied)[0]:
                self.last_mode_events.append({
                    "site": name,
                    "layer": int(lane) if stacked else None,
                    "before": mode_name(mode_id[lane]),
                    "after": mode_name(new_mode[lane]),
                    "sim_ema": float(sim_l[lane]),
                })
            if applied.any():
                # a mode flip also freezes the site's exec path for the
                # cooldown (and an exec flip freezes the mode lanes)
                self.exec_cooldown[name] = max(
                    self.exec_cooldown.get(name, 0), int(hyst[applied].max()))
            self._write_modes(entry, new_mode)
            ctrl["cooldown"].copy_(torch.from_numpy(
                new_cd.astype(np.int32).reshape(tuple(ctrl["cooldown"].shape))))
        return self.refresh_exec_paths(cache, snapshot=snap)

    def refresh_exec_paths(
        self, cache: dict[str, Any], *, snapshot: dict[str, Any] | None = None,
    ) -> dict[str, str]:
        """Promote/demote execution paths from the MEASURED cumulative tile
        skip rate, with a site-level cooldown. Returns {site: "exec:<path>"}
        for the sites that moved."""
        if snapshot is None:
            snapshot = self.ctrl_snapshot(cache)
        changed: dict[str, str] = {}
        for name, spec in self.sites.items():
            s = snapshot.get(name, {})
            if "skipped" not in s:
                continue
            skipped = float(s["skipped"])
            computed = float(s["computed"])
            total = skipped + computed
            if total <= 0:
                continue
            new_path = self.policy.decide_exec_path(
                spec, skipped / total, impl=self.impl)
            if new_path == resolve_exec_path(spec, self.impl):
                self.exec_cooldown[name] = max(
                    0, self.exec_cooldown.get(name, 0) - 1)
                continue
            if self.exec_cooldown.get(name, 0) > 0:
                self.exec_cooldown[name] -= 1
                continue
            gk = -(-spec.in_features // spec.block_k)
            budget = None
            if new_path in ("ragged", "compact"):
                budget = self.policy.resolve_max_active_k(name)
                if budget is None:
                    budget = self.policy.ragged_budget(gk, skipped / total)
            self.sites[name] = dataclasses.replace(
                spec, exec_path=new_path, max_active_k=budget)
            changed[name] = f"exec:{new_path}"
            hyst = self.policy.resolve(name).hysteresis_steps
            self.exec_cooldown[name] = hyst
            ctrl = cache[name].get("ctrl")
            if ctrl is not None:
                ctrl["cooldown"].clamp_(min=hyst)
        return changed

    def sensor_report(self, cache: dict[str, Any]):
        """Measured reuse accounting for the whole model (a SensorReport)."""
        from repro_torch.sensor.aggregate import build_report

        return build_report(self, cache)
