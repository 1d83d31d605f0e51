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
  spec changes and are returned;
* `layer_modes` / `site_mode` / `mode_summary` read the mode mirror, and
  `set_budget` re-points a compacted site's budget (the control plane's
  write paths, `repro_torch.control`);
* `ctrl_snapshot(cache, sentinels=True)` also carries the guard plane's
  sentinel lanes (`repro_torch.guard.sentinel.sentinel_lanes`) in the same
  one transfer, as the reference's `_ctrl_snapshot_device` does. Only the
  breaker asks for them: eager, they are about 20 small device ops a site
  (PERF.md §6), where the reference's ride its one jitted pass.

Every write goes into the existing tensors (`copy_`, indexed assignment):
a captured CUDA graph reads the tensors it was captured on.

Budgets: a site's k-extent budget reaches only the accounting of the
ragged and compact paths (both compute every live block). It is read from a per-site device
scalar, the budget lane (`budget_lanes`), which every budget move writes in
place, so a budget move changes neither the device work nor a compiled
step's decode key. The lanes live on the engine, not in the cache, so the
cache's leaves stay the reference's.

Model-axis sharding (`shard_sites(S)` before `init_cache`, the reference's
`serve --mesh host:S`): every site's weight splits into S column panels and
its cache gains a shard axis inside the layer axis ([L, S, ...]), prev_out
holding each shard's columns and every other leaf replicated. `apply` runs
the shard-local evaluation once a shard (its own delta_quant on its replica
of prev_q, its own GEMM on its panel, read in place), writes each shard's
columns into one output, and crosses no shard. The ctrl snapshot is the
once-a-window cross-mesh reduce: counters summed over shards (the
ownership partition makes the sums the unsharded counters), per-shard skip
lanes beside them, ctrl lanes from shard 0, sentinel lanes combined; its
payload, and the ctrl lanes the host passes write to every shard, are
metered into `ici_reduce_bytes` and `ici_write_bytes` as the reference
meters them.

Placement (`place(placement)` after `shard_sites`, under a process group:
one process a card, `repro_torch.dist.shard.Placement`): the rank holds
model-axis shard `rank % S`. `init_cache` builds only its lane of every
sharded site ([L, 1, ...], [1, ...]); `apply` evaluates that shard alone,
at the same `ShardCtx` and k split, and all-gathers the [*lead, N/S]
panels over the model group into the [*lead, N] output, in column order
(each panel is the one-device kernel call's, so the output is bitwise the
one-device output); the ctrl snapshot packs the rank's lanes as above and
rebuilds the one-device layout with one all-gather of the packed vectors
before its one device→host copy, so every rank reads the same snapshot and
takes the same host decisions. Host writes (ctrl syncs, mode refreshes)
write the rank's own lane in place; the meters count every shard's lane,
as on one device.
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
from repro_torch.dist.shard import (
    Placement,
    host_arrays,
    plan_local_spec,
    shard_axis_of,
    shard_view,
    validate_shardable,
)
from repro_torch.kernels.ops import clamp_budget
from repro_torch.obs import trace
from repro_torch.sensor.counters import ShardCtx

# ctrl_snapshot lanes, in the order they are packed per site; the sentinel
# lanes (guard/sentinel.py), when asked for, follow them, each an int32
# count or bitmask
_SNAP_LANES = ("sim_l", "mode_id", "sim_threshold", "min_work", "cooldown",
               "quarantine")
_SNAP_DTYPES = {"sim_l": np.float32, "mode_id": np.int8,
                "sim_threshold": np.float32, "min_work": np.float32,
                "cooldown": np.int32, "quarantine": np.int32}


def _window_sum(v: list[torch.Tensor]) -> torch.Tensor:
    """Sum of the lane slices `v`, in the order of XLA's CPU reduction: up to
    32 lanes are added in lane order; more are cut into reduce-windows of 32
    whose padding P = 32·ceil(n/32) − n is split floor(P/2) low and
    ceil(P/2) high, each window is summed in lane order, and the window sums
    are reduced by the same rule."""
    n = len(v)
    if n <= 32:
        acc = v[0]
        for x in v[1:]:
            acc = acc + x
        return acc
    lo = (32 * -(-n // 32) - n) // 2
    sums = [_window_sum(v[max(0, 32 * w - lo):32 * (w + 1) - lo])
            for w in range(-(-n // 32))]
    return _window_sum(sums)


def lane_mean(sim: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (the batch lanes), rounded as the reference's
    compiled `jnp.mean(sim, axis=-1)` on the CPU: the lanes are summed by
    `_window_sum` (XLA's reduce-window rewrite) and the total is multiplied
    by f32(1 / M). Every step is an elementwise f32 add of lane slices, so
    the bits are the same on the CPU and on the card, at every batch width
    (tests/test_torch_engine.py holds it against the compiled mean)."""
    m = sim.shape[-1]
    total = _window_sum([sim[..., j] for j in range(m)])
    return total * float(np.float32(1.0 / m))


def _combine_shard_sentinels(
    lanes: list[dict[str, torch.Tensor]],
) -> dict[str, torch.Tensor]:
    """Collapse the shards' sentinel lanes ([L] each) into one [L] set,
    keeping each lane's detection: disjoint counts sum (prev_out columns
    and the counter ownership partition split across shards), replicated
    health flags take the max (one corrupt shard must still trip), and the
    ctrl range bitmask ORs (a max would drop bits when shards fail
    different checks)."""
    out = {"bad_out": torch.stack([ln["bad_out"] for ln in lanes]).sum(
               dim=0, dtype=torch.int32),
           "bad_sim": torch.stack([ln["bad_sim"] for ln in lanes]).amax(dim=0),
           "steps_l": lanes[0]["steps_l"]}
    if "ctrl_bad" in lanes[0]:
        bad = lanes[0]["ctrl_bad"]
        for ln in lanes[1:]:
            bad = bad | ln["ctrl_bad"]
        out["ctrl_bad"] = bad
        out["quarantine"] = torch.stack(
            [ln["quarantine"] for ln in lanes]).amax(dim=0)
    if "skipped_l" in lanes[0]:
        for key in ("skipped_l", "computed_l"):
            out[key] = torch.stack([ln[key] for ln in lanes]).sum(
                dim=0, dtype=torch.int32)
    return out


def reduce_payload_bytes(lanes: int, shards: int) -> float:
    """Bytes the reference's ctrl snapshot moves for one sharded site with
    `lanes` layer lanes: sim_l, sim_threshold, min_work (f32), mode_id
    (int8) and cooldown (int32) of shard 0; the skipped and computed sums
    (int32); the [S] per-shard skip lanes (int32); and its seven combined
    int32 sentinel lanes, which ride every snapshot there."""
    return float(lanes * (4 + 1 + 4 + 4 + 4) + 2 * 4 + 2 * 4 * shards
                 + 7 * 4 * lanes)


@dataclasses.dataclass
class ReuseEngine:
    policy: ReusePolicy = dataclasses.field(default_factory=ReusePolicy)
    impl: str = "cuda"
    sites: dict[str, ReuseSiteSpec] = dataclasses.field(default_factory=dict)
    stacking: dict[str, int] = dataclasses.field(default_factory=dict)
    exec_cooldown: dict[str, int] = dataclasses.field(default_factory=dict)
    last_mode_events: list[dict] = dataclasses.field(default_factory=list)
    last_snapshot: dict[str, Any] | None = None
    # model-axis shard count per site (empty: unsharded), set by
    # shard_sites() before init_cache
    shards: dict[str, int] = dataclasses.field(default_factory=dict)
    # interconnect accounting (bytes, cumulative) as the reference meters
    # it: the per-window cross-mesh counter reduce riding the ctrl
    # snapshot, and the ctrl lanes written to every shard
    ici_reduce_bytes: float = 0.0
    ici_write_bytes: float = 0.0
    # per-site int32 device scalar holding the clamped k-extent budget that
    # the ragged accounting reads, and the value last written to each
    budget_lanes: dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    _budget_host: dict[str, int] = dataclasses.field(default_factory=dict)
    # where the latest `init_cache` put the cache (the guard's shadow probe
    # runs there)
    device: torch.device | None = None
    # one shard a card: this rank's place (None: every shard lane on one
    # device), set by place() before init_cache
    placement: Placement | None = None

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

    def shard_sites(self, n_shards: int) -> dict[str, int]:
        """Plan an N-way model-axis split of every registered site, before
        `init_cache`: validates divisibility up front and records the plan
        in `self.shards`; `init_cache` then adds the shard axis, `apply`
        runs each shard's evaluation and the ctrl snapshot collapses the
        shard lanes. n_shards <= 1 clears the plan (unsharded)."""
        if n_shards <= 1:
            self.shards = {}
            return self.shards
        for spec in self.sites.values():
            validate_shardable(spec, n_shards)
        self.shards = {name: n_shards for name in self.sites}
        return self.shards

    def place(self, placement: Placement | None) -> None:
        """Hold only `placement.shard`'s lane of every sharded site (one
        process a card), before `init_cache`; None: every lane here."""
        if placement is not None and any(
                n != placement.n_shards for n in self.shards.values()):
            raise ValueError(
                f"the sites are planned for {sorted(set(self.shards.values()))}"
                f" shards but the placement's model axis is "
                f"{placement.n_shards} wide")
        self.placement = placement

    def lanes_held(self, name: str) -> int:
        """Shard lanes of site `name` this process holds: 0 unsharded, 1
        placed, else every shard's."""
        n_shards = self.shards.get(name, 0)
        return 1 if n_shards and self.placement is not None else n_shards

    def init_cache(self, batch: int, *, device="cuda") -> dict[str, Any]:
        # the device with its index, as a tensor there reports it
        self.device = torch.empty(0, device=device).device
        cache: dict[str, Any] = {}

        def lead(n):  # broadcast every leaf to a new leading axis of n
            return lambda x: (x.expand(n, *x.shape).clone()
                              if isinstance(x, torch.Tensor)
                              else np.repeat(x[None], n, axis=0))

        for name, spec in self.sites.items():
            n_shards = self.shards.get(name, 0)
            if n_shards:
                spec = plan_local_spec(spec, n_shards)
            entry = init_site_cache(spec, batch, self.policy.resolve(name),
                                    device=device)
            if n_shards:
                # shard axis first, the layer axis wraps it: [S, ...]
                # unstacked, [L, S, ...] stacked ([L, 1, ...] placed); the
                # initial state is the same on every shard (prev_out zeros
                # at the local N). The host mirror of the mode lanes keeps
                # every shard's lane on every rank: each reads shard 0's
                mirror = lead(n_shards)(entry.pop("mode_host"))
                entry = map_tensors(lead(self.lanes_held(name)), entry)
                entry["mode_host"] = mirror
            n_layers = self.stacking[name]
            if n_layers:
                entry = map_tensors(lead(n_layers), entry)
                ts = [self.policy.resolve(name, layer=layer)
                      for layer in range(n_layers)]
                for key, vals in (
                        ("sim_threshold", [t.sim_threshold for t in ts]),
                        ("min_work", [t.min_work_flops for t in ts])):
                    entry["ctrl"][key] = self._site_lane(
                        name, torch.tensor(vals, dtype=torch.float32,
                                           device=device))
            cache[name] = entry
            lane = self.budget_lanes.get(name)
            if lane is None or lane.device != self.device:
                self.budget_lanes[name] = torch.zeros(
                    (), dtype=torch.int32, device=device)
                self._budget_host.pop(name, None)
        self.sync_budgets()
        return cache

    # ---------------------------------------------------------- budget lanes

    @staticmethod
    def clamped_budget(spec: ReuseSiteSpec) -> int:
        """The budget the accounting reads: `max_active_k` clamped to
        [1, gk], gk when the site has none."""
        return clamp_budget(spec.max_active_k,
                            -(-spec.in_features // spec.block_k))

    def sync_budgets(self) -> None:
        """Write every budget lane whose value trails its site's spec (a
        fill_ in place; nothing is read back). `set_budget` calls it, the
        compiled step before each decode (a graph replays without running
        `apply`), and `budget_lane` when an eager call finds a lane stale
        (any other spec move)."""
        for name, lane in self.budget_lanes.items():
            kb = self.clamped_budget(self.sites[name])
            if self._budget_host.get(name) != kb:
                if lane.is_cuda and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        f"budget lane of site {name!r} written during a CUDA "
                        "graph capture: a replay would repeat the write")
                lane.fill_(kb)
                self._budget_host[name] = kb

    def budget_lane(self, name: str, device: torch.device):
        """Site `name`'s budget lane on `device` (synced), or None when the
        engine holds none there (a cache built outside `init_cache`): the
        accounting then reads the spec's Python int."""
        lane = self.budget_lanes.get(name)
        if lane is None or lane.device != device:
            return None
        if self._budget_host.get(name) != self.clamped_budget(
                self.sites[name]):
            self.sync_budgets()
        return lane

    def _site_lane(self, name: str, per_layer, *, every_shard=False):
        """Per-layer values ([L], or [1] unstacked) in the ctrl lane's
        layout: replicated over the shard axis of a sharded site (every
        shard runs the layer's operating point). A tensor stays a tensor on
        its device, a numpy array numpy. Placed, the rank's one lane, or
        with `every_shard` every shard's (the mode mirror's layout)."""
        n_shards = (self.shards.get(name, 0) if every_shard
                    else self.lanes_held(name))
        if not n_shards:
            return per_layer
        if self.stacking.get(name, 0) > 0:
            rows = per_layer.reshape(-1, 1)
            shape = (rows.shape[0], n_shards)
        else:
            rows, shape = per_layer.reshape(1), (n_shards,)
        if isinstance(rows, torch.Tensor):
            return rows.expand(shape).contiguous()
        return np.broadcast_to(rows, shape).copy()

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
        trace.mark(name, None)  # a marked capture's timing events, else none
        if self.shards.get(name):
            out = self._apply_sharded(name, x, w, b, cache_entry, mode)
        else:
            out = reuse_linear(x, w, b, cache_entry, spec, mode=mode,
                               impl=self.impl,
                               budget=self.budget_lane(name, x.device))
        trace.mark(name, "epilogue")
        return out

    def _apply_sharded(
        self,
        name: str,
        x: torch.Tensor,
        w: torch.Tensor,
        b: torch.Tensor | None,
        entry: dict[str, Any],
        mode: str | None,
    ) -> tuple[torch.Tensor, dict[str, Any], ReuseStats]:
        """One sharded site call: the shard-local evaluation once a shard,
        on the shard's column panel `w[:, s·nl:(s+1)·nl]` (a view: no
        weight is copied) and its lane of the entry ([S, ...]), each
        written into its columns of one [*lead, N] output. Nothing crosses
        shards. Placed, the rank's shard alone, its panel all-gathered
        with the others' into the output. The layer's mode is replicated
        across shards and read once, from the host mirror's shard 0 (every
        rank's mirror holds every shard's lane), as the reference takes its
        branch once outside its vmap."""
        spec = self.sites[name]
        n_shards = self.shards[name]
        nl = spec.out_features // n_shards
        local = dataclasses.replace(spec, out_features=nl)
        gn_total = -(-spec.out_features // spec.block_n)
        if mode is None:
            if "ctrl" not in entry:
                raise ValueError(
                    f"site {name!r}: sharded mode=None needs a ctrl block "
                    "in the cache entry (engine.init_cache creates it)")
            mode = ("reuse" if int(np.reshape(entry["mode_host"], -1)[0]) > 0
                    else "basic")
        budget = self.budget_lane(name, x.device)
        if self.placement is not None:
            # this rank's shard on its panel, then the panels of the model
            # group side by side: an activation all-gather
            s = self.placement.shard
            cols = slice(s * nl, (s + 1) * nl)
            part, _, stats = reuse_linear(
                x, w[:, cols], None if b is None else b[cols],
                shard_view(entry, 0, 0), local, mode=mode, impl=self.impl,
                budget=budget,
                shard=ShardCtx(s, n_shards, spec.out_features, gn_total))
            panels = self.placement.all_gather(part)  # [S, *lead, N/S]
            return torch.cat(panels.unbind(0), dim=-1), entry, stats
        out = stats = None
        for s in range(n_shards):
            cols = slice(s * nl, (s + 1) * nl)
            part, _, st = reuse_linear(
                x, w[:, cols], None if b is None else b[cols],
                shard_view(entry, 0, s), local, mode=mode, impl=self.impl,
                budget=budget,
                shard=ShardCtx(s, n_shards, spec.out_features, gn_total))
            if out is None:
                out = torch.empty((*part.shape[:-1], spec.out_features),
                                  dtype=part.dtype, device=part.device)
                stats = st  # replicated per shard
            out[..., cols] = part
        return out, entry, stats

    # ------------------------------------------------ ctrl-block interrogation
    # The mode helpers read the host mirror: the control plane asks for every
    # site on every interval, and a read of the device lane is one sync each.

    @staticmethod
    def entry_mode_ids(entry: dict[str, Any]) -> np.ndarray:
        """A site's per-layer mode ids as a 1-d host array ([1] unstacked)."""
        return np.atleast_1d(np.asarray(entry["mode_host"]))

    def _mode_ids(self, cache: dict[str, Any], name: str) -> np.ndarray:
        """Per-layer mode ids with the shard lane collapsed (mode lanes are
        replicated across model shards, so lane 0 is the site's truth)."""
        ids = np.asarray(cache[name]["mode_host"])
        if self.shards.get(name, 0):
            ids = np.take(ids, 0, axis=shard_axis_of(
                self.stacking.get(name, 0)))
        return np.atleast_1d(ids)

    def layer_modes(self, cache: dict[str, Any], name: str) -> list[str]:
        return [mode_name(m) for m in self._mode_ids(cache, name)]

    def site_mode(self, cache: dict[str, Any], name: str) -> str:
        """One site's kernelMode summary: "reuse"/"basic" when uniform over
        layers, "mixed" when a stack settled distinct per-layer modes."""
        ids = self._mode_ids(cache, name)
        if np.all(ids == ids[0]):
            return mode_name(ids[0])
        return "mixed"

    def mode_summary(self, cache: dict[str, Any]) -> dict[str, str]:
        return {name: self.site_mode(cache, name) for name in self.sites}

    # ------------------------------------------------------- kernelMode writes

    def _write_modes(self, name: str, entry: dict[str, Any],
                     mode_ids: np.ndarray) -> None:
        """Write a site's mode ids (in the mirror's layout: every shard's
        lane) to its host mirror and the device lane (placed: the rank's
        lane of them)."""
        new = np.asarray(mode_ids, np.int8).reshape(entry["mode_host"].shape)
        entry["mode_host"][...] = new
        if self.shards.get(name) and self.placement is not None:
            new = np.take(new, [self.placement.shard], axis=shard_axis_of(
                self.stacking.get(name, 0)))
        entry["ctrl"]["mode_id"].copy_(torch.from_numpy(new.copy()))

    def sync_mode_mirror(self, cache: dict[str, Any]) -> None:
        """Rebuild every site's host mirror from its device mode lanes, in
        one copy (placed: every rank's lanes, one collective), as after a
        restore into the lanes."""
        names = [n for n, e in cache.items() if "ctrl" in e]
        lanes = host_arrays(
            [cache[n]["ctrl"]["mode_id"] for n in names],
            [shard_axis_of(self.stacking.get(n, 0)) if self.shards.get(n)
             else None for n in names], self.placement)
        for n, a in zip(names, lanes):
            cache[n]["mode_host"][...] = a

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
        self._write_modes(name, entry, new)

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
        for key, vals in (("sim_threshold", [t.sim_threshold for t in ts]),
                          ("min_work", [t.min_work_flops for t in ts])):
            lane = self._site_lane(
                name, torch.tensor(vals, dtype=torch.float32))
            ctrl[key].copy_(lane.reshape(ctrl[key].shape))
            if name in self.shards:  # written to every shard's lane
                self.ici_write_bytes += float(len(vals)) * 4 * self.shards[
                    name]

    def set_budget(self, name: str, budget: int) -> bool:
        """Re-point a compacted site's k-extent budget (the online budget
        adapter's write path), keeping the policy table in sync so the next
        exec-path refresh or retune does not revert it. Site-granular, as
        in the reference. Returns True when the spec changed. The ragged
        kernel walks the live counts, so a new budget changes only the
        accounting (`ops.ragged_grid_steps`, `ops.budget_overflow`), which
        reads the site's budget lane: the lane is written in place, and the
        compiled step's decode key stays."""
        spec = self.sites[name]
        if spec.exec_path not in ("ragged", "compact"):
            return False
        gk = -(-spec.in_features // spec.block_k)
        budget = clamp_budget(int(budget), gk)
        if budget == spec.max_active_k:
            return False
        self.sites[name] = dataclasses.replace(spec, max_active_k=budget)
        self.policy.site_tunables[name] = dataclasses.replace(
            self.policy.resolve(name), max_active_k=budget)
        self.sync_budgets()
        return True

    # -------------------------------------------------- host-side policy pass

    def ctrl_snapshot(self, cache: dict[str, Any], *,
                      sentinels: bool = False) -> dict[str, Any]:
        """Everything the host passes read, for ALL sites, in ONE device→host
        transfer: per-layer sim_ema means, the ctrl lanes and the sensor tile
        sums (with `sentinels`, also the guard's sentinel lanes) are packed
        on the device into one f64 vector (every value is exact in f64: the
        sentinel lanes are int32 counts and bitmasks) and copied once.

        On a sharded engine this snapshot is also the once-a-window
        cross-mesh reduce: a sharded site's counters sum over all axes
        (layers and shards), its per-shard skip lanes (`skipped_shard`,
        `computed_shard`, [S]) ride along, its replicated ctrl and sim
        lanes come from shard 0 (quarantine: the max over shards), and its
        sentinel lanes are combined across shards
        (`_combine_shard_sentinels`). The reference's payload for those
        sites is metered into `ici_reduce_bytes`."""
        from repro_torch.guard.sentinel import sentinel_lanes

        # every lane with its shard axis kept (placed: this rank's lane of
        # it), reduced on the device; then one copy of them all in the
        # one-device layout (`host_arrays`), collapsed on the host
        lanes: dict[str, dict[Any, torch.Tensor]] = {}
        leaves, axes, paths = [], [], []
        for name, entry in cache.items():
            ctrl = entry.get("ctrl")
            n_shards = self.shards.get(name, 0)
            ax = shard_axis_of(self.stacking.get(name, 0)) if n_shards \
                else None
            site: dict[Any, tuple[torch.Tensor, int | None]] = {}
            if ctrl is not None:
                sim = entry["sim_ema"]
                site["sim_l"] = (sim if sim.ndim == 0 else lane_mean(sim), ax)
                for key in _SNAP_LANES[1:]:
                    site[key] = (ctrl[key], ax)
            sensor = entry.get("sensor")
            if sensor is not None:
                for key, src in (("skipped", "skipped_tiles"),
                                 ("computed", "computed_tiles")):
                    # the ownership partition: the plain sum over layers
                    # and shards is the global count
                    t = sensor[src]
                    other = tuple(i for i in range(t.ndim) if i != ax)
                    site[key] = ((t.sum(dim=other) if other else t, 0)
                                 if n_shards else (t.sum(), None))
            if sentinels and ctrl is not None:
                if n_shards:  # [L, S]: one [L] set a shard lane, side by side
                    per = [sentinel_lanes(shard_view(entry, ax, i))
                           for i in range(self.lanes_held(name))]
                    for k in per[0]:
                        site["sentinel", k] = (
                            torch.stack([p[k] for p in per], dim=1), 1)
                else:
                    for k, v in sentinel_lanes(entry).items():
                        site["sentinel", k] = (v, None)
            if n_shards and ctrl is not None:
                self.ici_reduce_bytes += reduce_payload_bytes(
                    max(1, self.stacking.get(name, 0)), n_shards)
            for key, (t, a) in site.items():
                leaves.append(t)
                axes.append(a)
                paths.append((name, key))
        for (name, key), a in zip(paths, host_arrays(leaves, axes,
                                                     self.placement)):
            lanes.setdefault(name, {})[key] = torch.from_numpy(a)
        snap: dict[str, Any] = {name: {} for name in cache}
        for name, site in lanes.items():
            n_shards = self.shards.get(name, 0)
            ax = shard_axis_of(self.stacking.get(name, 0))
            out: dict[str, Any] = {}
            for key in _SNAP_LANES:
                if key not in site:
                    continue
                v = site[key]
                if n_shards:  # replicated across shards: lane 0, but the
                    # quarantine lockout takes the max over shards
                    v = v.amax(dim=ax) if key == "quarantine" else v.select(
                        ax, 0)
                out[key] = v
            for key in ("skipped", "computed"):
                if key in site:
                    out[key] = int(site[key].sum())
                    if n_shards:
                        out[key + "_shard"] = site[key]
            sent = {k[1]: v for k, v in site.items() if isinstance(k, tuple)}
            if sent and n_shards:  # combined across the shard lanes
                sent = _combine_shard_sentinels(
                    [{k: v[:, i] for k, v in sent.items()}
                     for i in range(n_shards)])
            for k, v in sent.items():
                out.setdefault(k, v)  # quarantine is a ctrl lane
            snap[name] = {key: v if isinstance(v, int) else v.reshape(
                -1).numpy().astype(_SNAP_DTYPES.get(key, np.int32))
                for key, v in out.items()}
        self.last_snapshot = snap
        return snap

    def host_cache(self, cache: dict[str, Any],
                   keys=("sensor", "steps", "ctrl")) -> dict[str, Any]:
        """Placed: host copies (numpy) of the tensor leaves under `keys` of
        every site entry, in the one-device layout, each sharded site's
        shard axis rebuilt from every rank's lane, in one collective and
        one device→host copy (`host_arrays`). The host readers
        of a placed cache (the sensor report, a slot's telemetry) read
        these, so every rank reads what the one-device engine reads."""
        leaves, axes, paths = [], [], []
        for name, entry in cache.items():
            ax = (shard_axis_of(self.stacking.get(name, 0))
                  if self.shards.get(name) else None)
            for key in keys:
                sub = entry.get(key)
                items = (sub.items() if isinstance(sub, dict)
                         else [(None, sub)] if sub is not None else [])
                for leaf_key, t in items:
                    if isinstance(t, torch.Tensor):
                        leaves.append(t)
                        axes.append(ax)
                        paths.append((name, key, leaf_key))
        arrays = host_arrays(leaves, axes, self.placement)
        out: dict[str, Any] = {name: {} for name in cache}
        for (name, key, leaf_key), a in zip(paths, arrays):
            if leaf_key is None:
                out[name][key] = a
            else:
                out[name].setdefault(key, {})[leaf_key] = a
        return out

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
            # decided per layer; a sharded site's lanes take the decision
            # on every shard (metered as the reference meters the fan-out)
            self._write_modes(name, entry, self._site_lane(
                name, new_mode, every_shard=True))
            ctrl["cooldown"].copy_(torch.from_numpy(
                self._site_lane(name, new_cd.astype(np.int32)).reshape(
                    tuple(ctrl["cooldown"].shape))))
            if name in self.shards:
                self.ici_write_bytes += float(n_lanes * self.shards[name]) * (
                    1 + 4)
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
