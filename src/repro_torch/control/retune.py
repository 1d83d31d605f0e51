"""Online retuner — windowed counter deltas → guardrailed SiteTunables moves.

The port of `repro.control.retune`. The offline loop (record JSONL →
`repro_torch.tune.fit` → reload) and this online path share ONE harvest
model: both build a :class:`~repro_torch.tune.trace.SiteTraceRecord`
describing a measured operating point and hand it to
:func:`repro_torch.tune.harvest.solve_site`. The difference is purely the
guardrails: an offline fit can jump straight to the solved target (a human
reviews the table), while the live retuner moves the installed tunables a
BOUNDED step toward the target each interval, so one noisy window can never
teleport the policy — and the hysteresis/cooldown machinery in
`ReuseEngine.refresh_modes` still owns the actual mode/exec transitions.

Guardrail asymmetry, deliberate: knobs that *restrict* harvesting
(sim_threshold moves, min_work raises) are throttled per interval, because a
wrongly-restricted site stops producing the very measurements that would
correct the mistake. Knobs that *admit* a site whose measured window is
net-positive (min_work lowering) apply immediately — the measurement already
justifies them, and a mis-admission keeps measuring and self-corrects the
next window (throttled back out, with the flip cooldown absorbing the churn).

Reading the counters: the reference reads each counter of each site with its
own `np.asarray`, a device→host copy each (about 12 a site). Here
`snapshot_cache` packs every site's counters on the device into one f64
vector (f64 holds every int32 and f32 value exactly), copies it once, and
restores each leaf's own dtype on the host; the sums are then the
reference's own numpy code on the same arrays, so every value is the
reference's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.policy import SiteTunables
from repro_torch.tune.harvest import BLOCK_K_CHOICES
from repro_torch.tune.trace import SiteTraceRecord


_COUNTER_KEYS = (
    "skipped_tiles", "computed_tiles", "skipped_macs", "computed_macs",
    "skipped_weight_bytes", "total_weight_bytes", "grid_steps",
    "mode_transitions",
)
# the sensor leaves a snapshot reads beyond _COUNTER_KEYS
_SNAP_EXTRA = ("overflow_fallbacks", "suppressed_flips", "slot_hit_sum",
               "slot_steps")
_NP_DTYPES = {torch.int32: np.int32, torch.float32: np.float32}


def snapshot_cache(cache: dict, names=None) -> dict[str, dict | None]:
    """Host-side snapshots (see `snapshot_entry`) of the sites `names`
    (default: every entry of `cache`), all read in ONE device→host
    transfer. A site without counters maps to None."""
    names = list(cache) if names is None else list(names)
    parts: list[torch.Tensor] = []
    layout: list[tuple[str, str, tuple, np.dtype]] = []
    for name in names:
        entry = cache[name]
        sensor = entry.get("sensor")
        if sensor is None:
            continue
        leaves = {k: sensor[k] for k in _COUNTER_KEYS + _SNAP_EXTRA
                  if k in sensor}
        leaves["steps"] = entry["steps"]
        for key, t in leaves.items():
            parts.append(t.reshape(-1).double())
            layout.append((name, key, tuple(t.shape), _NP_DTYPES[t.dtype]))
    flat = torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
    host: dict[str, dict] = {}
    pos = 0
    for name, key, shape, dtype in layout:
        n = math.prod(shape)
        host.setdefault(name, {})[key] = (
            flat[pos:pos + n].astype(dtype).reshape(shape))
        pos += n
    return {name: (_snapshot_host(host[name]) if name in host else None)
            for name in names}


def snapshot_entry(entry: dict, shard_axis: int | None = None) -> dict | None:
    """Host-side snapshot of one cache entry's cumulative counters, summed
    over any leading layer dimension (one small device→host transfer).

    For STACKED sites the snapshot additionally keeps the un-summed per-layer
    counter arrays under ``"layers"`` — the per-layer retune loop diffs those
    to give each layer of a stack its own windowed operating point.

    `shard_axis` names a model-sharded entry's shard axis in the reference;
    the port serves unsharded, so only None is accepted."""
    if shard_axis is not None:
        raise NotImplementedError(
            "sharded cache entries: sharded serving is not ported yet "
            "(ROADMAP Queue 1 item 10)")
    return snapshot_cache({"": entry})[""]


def _snapshot_host(sensor: dict[str, np.ndarray]) -> dict:
    """The reference's snapshot arithmetic, on host copies of one site's
    counters (`sensor` holds the counter leaves and "steps")."""

    def total(key: str) -> float:
        return float(np.sum(np.asarray(sensor[key])))

    snap = {k: total(k) for k in _COUNTER_KEYS}
    snap["overflow_fallbacks"] = (
        total("overflow_fallbacks") if "overflow_fallbacks" in sensor else 0.0
    )
    # suppression is a site-level event bumped on every layer slice at once
    snap["suppressed_flips"] = float(np.max(np.asarray(sensor["suppressed_flips"])))
    hit = np.asarray(sensor["slot_hit_sum"], np.float64)
    ss = np.asarray(sensor["slot_steps"], np.float64)
    if hit.ndim > 1:  # stacked site: per-layer arrays kept, lanes summed
        layers: dict[str, np.ndarray] = {
            k: np.asarray(sensor[k], np.float64) for k in _COUNTER_KEYS
        }
        layers["overflow_fallbacks"] = (
            np.asarray(sensor["overflow_fallbacks"], np.float64)
            if "overflow_fallbacks" in sensor
            else np.zeros(hit.shape[0])
        )
        layers["slot_hit_sum"] = hit          # [L, M]
        layers["slot_steps"] = ss             # [L, M]
        layers["steps"] = np.asarray(sensor["steps"], np.float64)
        snap["layers"] = layers
        hit = hit.sum(axis=tuple(range(hit.ndim - 1)))
        ss = ss.sum(axis=tuple(range(ss.ndim - 1)))
    snap["slot_hit_sum"] = hit
    snap["slot_steps"] = ss
    snap["steps"] = float(np.max(np.asarray(sensor["steps"])))
    return snap


def window_record(
    name: str,
    spec,
    mode: str,
    exec_path: str,
    prev: dict,
    cur: dict,
) -> SiteTraceRecord | None:
    """The window's measured operating point as a solver-ready trace record
    (counter deltas between two snapshots), or None for an empty window.

    Recycled lanes are filtered best-effort: a legitimate lane delta
    satisfies 0 <= d_hit <= d_steps up to the f32 accumulator's rounding
    (each evaluation adds one step and a [0, 1] similarity), so lanes whose
    accumulators went backwards OR out-accumulated their step delta
    (reset_slot zeroed them mid-window and a new occupant overran the old
    sums) drop out of the window's hit rate rather than poisoning it with
    cross-session or >1 values (`_window_hit_rate`)."""
    d = {k: cur[k] - prev[k] for k in cur if isinstance(cur[k], float)}
    steps = int(round(d["steps"]))
    if steps <= 0:
        return None
    hit = _window_hit_rate(
        cur["slot_hit_sum"] - prev["slot_hit_sum"],
        cur["slot_steps"] - prev["slot_steps"],
        cur["slot_hit_sum"],
    )
    return _record_from_deltas(
        name, spec, mode, exec_path, d, hit,
        batch=int(cur["slot_steps"].shape[-1]),
    )


def _window_hit_rate(d_hit: np.ndarray, d_ss: np.ndarray,
                     hit_end: np.ndarray) -> float:
    """Mean per-slot hit rate of a window from the lanes' deltas.

    Each evaluation adds a similarity in [0, 1] (K·f32(1/K), which can
    exceed 1 by an ulp's fraction) to an f32 accumulator that rounds by up
    to half an ulp of its value, so a lane whose every evaluation matched
    can close its window a few ulps past `d_ss`. The reference's filter
    (`d_hit <= d_ss`) drops such a lane — at full width a lane that reused
    everything — and with every lane dropped reads the window as hit 0, so
    the retuner demotes the lane that reuses most. Here a lane within that
    rounding slack (one ulp of its end value a step) counts, at rate 1;
    lanes further past, or gone backwards (reset mid-window), drop out."""
    slack = d_ss * np.spacing(np.maximum(hit_end, 1.0).astype(np.float32))
    active = (d_ss > 0) & (d_hit >= 0.0) & (d_hit <= d_ss + slack)
    if not active.any():
        return 0.0
    return float(np.mean(np.minimum(d_hit[active] / d_ss[active], 1.0)))


def _record_from_deltas(
    name: str, spec, mode: str, exec_path: str,
    d: dict[str, float], hit: float, *, batch: int, layer: int | None = None,
) -> SiteTraceRecord:
    skipped = d["skipped_tiles"]
    total_tiles = skipped + d["computed_tiles"]
    total_macs = d["skipped_macs"] + d["computed_macs"]
    gn = -(-spec.out_features // spec.block_n)
    dense_grid = total_tiles * gn
    return SiteTraceRecord(
        site=name,
        mode=mode,
        steps=int(round(d["steps"])),
        batch=batch,
        in_features=spec.in_features,
        out_features=spec.out_features,
        block_m=spec.block_m,
        block_k=spec.block_k,
        block_n=spec.block_n,
        tile_skip_rate=skipped / max(total_tiles, 1.0),
        mac_skip_rate=d["skipped_macs"] / max(total_macs, 1e-9),
        weight_byte_skip_rate=(
            d["skipped_weight_bytes"] / max(d["total_weight_bytes"], 1e-9)
        ),
        hit_rate=hit,
        mode_transitions=int(round(d["mode_transitions"])),
        suppressed_flips=int(round(d["suppressed_flips"])),
        total_weight_bytes=d["total_weight_bytes"],
        total_macs=total_macs,
        exec_path=exec_path,
        grid_steps=d["grid_steps"],
        grid_step_skip_rate=max(0.0, 1.0 - d["grid_steps"] / max(dense_grid, 1e-9)),
        overflow_fallbacks=int(round(d["overflow_fallbacks"])),
        layer=layer,
    )


def window_layer_records(
    name: str,
    spec,
    layer_modes: list[str],
    exec_path: str,
    prev: dict,
    cur: dict,
) -> dict[int, SiteTraceRecord]:
    """Per-layer windowed operating points of one STACKED site.

    Diffs the un-summed per-layer counter arrays both snapshots kept under
    ``"layers"`` and yields one solver-ready record per layer with a
    non-empty window — the input of the controller's per-layer retune loop
    (ctrl-lane thresholds, journaled per layer). Empty for unstacked sites
    or snapshots taken before the per-layer capture existed."""
    pl, cl = prev.get("layers"), cur.get("layers")
    if pl is None or cl is None:
        return {}
    n_layers = cl["slot_steps"].shape[0]
    out: dict[int, SiteTraceRecord] = {}
    for layer in range(n_layers):
        d = {k: float(cl[k][layer] - pl[k][layer]) for k in _COUNTER_KEYS}
        d["overflow_fallbacks"] = float(
            cl["overflow_fallbacks"][layer] - pl["overflow_fallbacks"][layer]
        )
        steps_arr = cl["steps"]
        d["steps"] = float(
            (steps_arr[layer] - pl["steps"][layer])
            if np.ndim(steps_arr) else (cur["steps"] - prev["steps"])
        )
        # suppression is site-level; a layer window inherits the site delta
        d["suppressed_flips"] = cur["suppressed_flips"] - prev["suppressed_flips"]
        if int(round(d["steps"])) <= 0:
            continue
        hit = _window_hit_rate(
            cl["slot_hit_sum"][layer] - pl["slot_hit_sum"][layer],
            cl["slot_steps"][layer] - pl["slot_steps"][layer],
            cl["slot_hit_sum"][layer],
        )
        mode = layer_modes[layer] if layer < len(layer_modes) else "auto"
        out[layer] = _record_from_deltas(
            name, spec, mode, exec_path, d, hit,
            batch=int(cl["slot_steps"].shape[-1]), layer=layer,
        )
    return out


def _step_block_k(current: int, target: int) -> int:
    """block_k moves at most one BLOCK_K_CHOICES notch per interval. Each
    move is a new decode key (a capture), and later tile counts accrue at
    the new granularity — CUMULATIVE tile rates therefore mix units across a move
    (the windowed deltas this retuner feeds the solver stay clean, and exec
    promotion under the controller rides the solver's pin rather than the
    cumulative signal, so only the unpinned `refresh_exec_paths` fallback
    sees the smeared rate)."""
    if target == current:
        return current
    choices = sorted(set(BLOCK_K_CHOICES) | {current, target})
    i = choices.index(current)
    j = choices.index(target)
    return choices[i + 1] if j > i else choices[i - 1]


def bounded_tunables(
    current: SiteTunables,
    target: SiteTunables,
    *,
    current_block_k: int,
    max_threshold_step: float,
    max_min_work_raise: float,
) -> tuple[SiteTunables, list[str]]:
    """Clamp one interval's move from `current` toward the solved `target`.

    Returns the tunables to install plus human-readable reasons for each
    field that moved. `current_block_k` is the spec's resolved granularity
    (the table entry may carry block_k=None)."""
    reasons: list[str] = []

    thr = target.sim_threshold
    lo = current.sim_threshold - max_threshold_step
    hi = current.sim_threshold + max_threshold_step
    thr = min(max(thr, lo), hi)
    if abs(thr - current.sim_threshold) > 1e-9:
        reasons.append(f"sim_threshold {current.sim_threshold:.3f}->{thr:.3f} "
                       f"(target {target.sim_threshold:.3f})")

    mw = target.min_work_flops
    if mw > current.min_work_flops:  # restricting: throttled
        mw = min(mw, current.min_work_flops * max_min_work_raise)
    if abs(mw - current.min_work_flops) > 1e-9:
        reasons.append(f"min_work {current.min_work_flops:.3e}->{mw:.3e}")

    tgt_bk = target.block_k if target.block_k is not None else current_block_k
    bk = _step_block_k(current_block_k, int(tgt_bk))
    if bk != current_block_k:
        reasons.append(f"block_k {current_block_k}->{bk} (target {tgt_bk})")

    # Exec promotion only once the granularity it was solved at is reached —
    # a pinned compacted path at an uncompactable block_k would just thrash.
    # Two deliberate asymmetries: (a) a below-break-even window RELEASES the
    # pin (exec_path=None) rather than pinning a demotion: an un-pinned site
    # falls back to `refresh_exec_paths`, which demotes from CUMULATIVE
    # counters under the flip cooldown — a pin the retuner never released
    # would make that demotion unreachable, since decide_exec_path honors
    # pins unconditionally; (b) the budget of a site already on the target
    # path belongs to the budget adapter (measured fallback rate) —
    # re-solving it every window would fight the adapter's moves (the SPEC
    # keeps its adapted budget across a pin release; only the table clears).
    exec_path = current.exec_path
    mak = current.max_active_k
    if (bk == tgt_bk and target.exec_path is not None
            and target.exec_path != current.exec_path):
        exec_path = target.exec_path
        mak = target.max_active_k
        reasons.append(f"exec_path {current.exec_path}->{exec_path}"
                       + (f"@{mak}" if mak is not None else ""))
    elif target.exec_path is None and current.exec_path is not None:
        exec_path = None
        mak = None
        reasons.append(f"exec_path pin {current.exec_path} released (window "
                       "below compaction break-even); demotion decided by "
                       "the cumulative refresh")

    out = SiteTunables(
        sim_threshold=thr,
        min_work_flops=mw,
        block_k=bk,
        hysteresis_margin=target.hysteresis_margin,
        hysteresis_steps=target.hysteresis_steps,
        exec_path=exec_path,
        max_active_k=mak,
    )
    return out, reasons
