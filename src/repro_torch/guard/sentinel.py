"""Invariant sentinels — cheap device-resident health checks on the reuse
state.

The port of `repro.guard.sentinel`. Two tiers, matching the cost they're
allowed to spend:

1. **Array sentinels** (`sentinel_lanes`): a handful of reductions over one
   cache entry — non-finite counts on prev_out, sim_ema range validation,
   ctrl-lane range bitmasks, per-layer counter lanes for conservation. They
   run on the device inside the engine's control snapshot when the breaker
   asks for them (`ReuseEngine.ctrl_snapshot(cache, sentinels=True)`), so
   detection rides the snapshot's one device→host copy: every lane is an
   int32 count or bitmask, exact in the snapshot's packed f64. `evaluate_snapshot` is the host half:
   it turns the copied lanes plus windowed counter deltas into named trip
   records.

2. **Dense shadow spot-check** (`shadow_check`): one (site, layer) is
   re-proven against the bitwise oracle — a deterministic synthetic probe
   built from integer-valued operands (every f32 accumulation exact whatever
   the order) runs the site's CURRENT spec (exec_path / block_k /
   max_active_k) down the reuse path and down a dense-oracle spec, and the
   outputs must be bitwise equal, on the card as on the CPU. It proves the
   substrate under the current operating point; live-state poisoning is the
   array sentinels' job (the probe uses fresh synthetic state so a poisoned
   live cache can't mask a substrate bug, and vice versa).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# ctrl-lane corruption bitmask (per layer) — which range check failed.
CTRL_BAD_MODE = 1        # mode_id outside {MODE_BASIC, MODE_REUSE}
CTRL_BAD_COOLDOWN = 2    # cooldown < 0
CTRL_BAD_THRESHOLD = 4   # sim_threshold non-finite or far outside [0, 1]
CTRL_BAD_MIN_WORK = 8    # min_work negative or non-finite
CTRL_BAD_OCCUPANCY = 16  # occupancy non-finite
CTRL_BAD_QUARANTINE = 32  # quarantine < 0

# sim_ema is an EMA of per-row code-match fractions in [0, 1]; allow float
# rounding slack before calling a value corrupt.
_SIM_EPS = 1e-5
# sim_threshold is retuner-moved; anything inside this generous band is a
# legitimate operating point, outside it is corruption.
_THR_LO, _THR_HI = -0.5, 1.5


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return cond.to(torch.int32) * bit


def sentinel_lanes(entry: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Array-sentinel reductions for one cache entry, on its device (no
    value is read on the host).

    Returns per-layer int32 lanes (leading [L]; unstacked entries get [1]):

        bad_out       non-finite prev_out element count
        bad_sim       sim_ema values non-finite or outside [-eps, 1+eps]
        ctrl_bad      CTRL_BAD_* bitmask of range violations
        quarantine    the guard lockout lane (0 on pre-guard ctrl blocks)
        skipped_l     per-layer skipped-tile counter
        computed_l    per-layer computed-tile counter
        steps_l       per-layer evaluation counter
    """
    out: dict[str, torch.Tensor] = {}
    prev_out = entry["prev_out"]
    # [L, M, N] stacked / [M, N] unstacked → reduce the trailing two axes
    out["bad_out"] = torch.atleast_1d(
        (~torch.isfinite(prev_out)).sum(dim=(-2, -1), dtype=torch.int32))

    sim = entry["sim_ema"]
    sim_bad = ((~torch.isfinite(sim)) | (sim < -_SIM_EPS)
               | (sim > 1.0 + _SIM_EPS)).to(torch.int32)
    if sim.ndim >= 1:  # [L, M] / [M] → per-layer count
        sim_bad = sim_bad.sum(dim=-1, dtype=torch.int32)
    out["bad_sim"] = torch.atleast_1d(sim_bad)

    ctrl = entry.get("ctrl")
    if ctrl is not None:
        mode_id = torch.atleast_1d(ctrl["mode_id"]).to(torch.int32)
        cd = torch.atleast_1d(ctrl["cooldown"])
        thr = torch.atleast_1d(ctrl["sim_threshold"])
        mw = torch.atleast_1d(ctrl["min_work"])
        occ = torch.atleast_1d(ctrl["occupancy"])
        quar = torch.atleast_1d(
            ctrl.get("quarantine", torch.zeros_like(ctrl["cooldown"])))
        bad = _bit((mode_id < 0) | (mode_id > 1), CTRL_BAD_MODE)
        bad = bad | _bit(cd < 0, CTRL_BAD_COOLDOWN)
        bad = bad | _bit(~torch.isfinite(thr) | (thr < _THR_LO)
                         | (thr > _THR_HI), CTRL_BAD_THRESHOLD)
        bad = bad | _bit(~torch.isfinite(mw) | (mw < 0), CTRL_BAD_MIN_WORK)
        bad = bad | _bit(~torch.isfinite(occ), CTRL_BAD_OCCUPANCY)
        bad = bad | _bit(quar < 0, CTRL_BAD_QUARANTINE)
        out["ctrl_bad"] = bad
        out["quarantine"] = quar.to(torch.int32)

    sensor = entry.get("sensor")
    if sensor is not None:
        out["skipped_l"] = torch.atleast_1d(
            sensor["skipped_tiles"]).to(torch.int32)
        out["computed_l"] = torch.atleast_1d(
            sensor["computed_tiles"]).to(torch.int32)
    out["steps_l"] = torch.atleast_1d(entry["steps"]).to(torch.int32)
    return out


_CTRL_BAD_NAMES = {
    CTRL_BAD_MODE: "mode_id",
    CTRL_BAD_COOLDOWN: "cooldown",
    CTRL_BAD_THRESHOLD: "sim_threshold",
    CTRL_BAD_MIN_WORK: "min_work",
    CTRL_BAD_OCCUPANCY: "occupancy",
    CTRL_BAD_QUARANTINE: "quarantine",
}


def _bad_lanes(mask: int) -> str:
    names = [n for bit, n in _CTRL_BAD_NAMES.items() if mask & bit]
    return "+".join(names) or "none"


@dataclasses.dataclass(frozen=True)
class Trip:
    """One tripped sentinel: which check, where, and the measured evidence."""

    site: str
    layer: int | None   # None = unstacked site
    check: str          # "nonfinite_out" | "sim_range" | "ctrl_range" |
    #                     "conservation" | "shadow"
    evidence: str


def evaluate_snapshot(
    name: str,
    lanes: dict[str, Any],
    *,
    stacked: bool,
    tiles_per_eval: int | None = None,
    prev: dict[str, np.ndarray] | None = None,
) -> list[Trip]:
    """Host half of the array sentinels: lanes (host numpy, as the snapshot
    returns them) → named per-layer trip records.

    `tiles_per_eval` (gm·gk of the site's CURRENT geometry) enables the
    counter-conservation check over the window since `prev` (the previous
    interval's lanes): Δskipped + Δcomputed must equal Δsteps · gm · gk. The
    caller passes `tiles_per_eval=None` for windows where block_k changed —
    the delta would mix tile units across granularities and trip falsely.
    """
    trips: list[Trip] = []
    bad_out = np.asarray(lanes["bad_out"])
    n_lanes = bad_out.shape[0]

    def _layer(i: int) -> int | None:
        return i if stacked else None

    for i in range(n_lanes):
        if bad_out[i] > 0:
            trips.append(Trip(
                site=name, layer=_layer(i), check="nonfinite_out",
                evidence=f"{int(bad_out[i])} non-finite prev_out elements",
            ))
    bad_sim = np.asarray(lanes["bad_sim"])
    for i in range(bad_sim.shape[0]):
        if bad_sim[i] > 0:
            trips.append(Trip(
                site=name, layer=_layer(i), check="sim_range",
                evidence=f"{int(bad_sim[i])} sim_ema values non-finite or "
                         f"outside [0, 1]",
            ))
    ctrl_bad = np.asarray(lanes.get("ctrl_bad", np.zeros(0, np.int32)))
    for i in range(ctrl_bad.shape[0]):
        if ctrl_bad[i]:
            trips.append(Trip(
                site=name, layer=_layer(i), check="ctrl_range",
                evidence=f"ctrl lanes out of range: "
                         f"{_bad_lanes(int(ctrl_bad[i]))}",
            ))
    if (tiles_per_eval is not None and prev is not None
            and "skipped_l" in lanes and "skipped_l" in prev):
        d_skip = np.asarray(lanes["skipped_l"]) - np.asarray(prev["skipped_l"])
        d_comp = (np.asarray(lanes["computed_l"])
                  - np.asarray(prev["computed_l"]))
        d_steps = np.asarray(lanes["steps_l"]) - np.asarray(prev["steps_l"])
        for i in range(d_skip.shape[0]):
            expect = int(d_steps[i]) * tiles_per_eval
            got = int(d_skip[i]) + int(d_comp[i])
            if got != expect:
                trips.append(Trip(
                    site=name, layer=_layer(i), check="conservation",
                    evidence=f"Δskipped+Δcomputed={got} != "
                             f"Δsteps·gm·gk={expect} "
                             f"(Δsteps={int(d_steps[i])}, "
                             f"tiles/eval={tiles_per_eval})",
                ))
    return trips


# --------------------------------------------------------------- shadow check


def _probe_operands(spec, batch: int, seed: int):
    """Deterministic integer-valued probe operands for one site: every f32
    accumulation is exact regardless of order, so reuse-vs-dense compares
    BITWISE."""
    rng = np.random.default_rng(seed)
    k, n = spec.in_features, spec.out_features
    # two consecutive integer activations with ~half the codes shared, so the
    # probe exercises a mixed tile mask (skip + compute + telescoping)
    x0 = rng.integers(-3, 4, size=(batch, k)).astype(np.float32)
    x1 = np.where(rng.random((batch, k)) < 0.5, x0,
                  rng.integers(-3, 4, size=(batch, k))).astype(np.float32)
    w = rng.integers(-2, 3, size=(k, n)).astype(np.float32)
    return x0, x1, w


def shadow_check(
    engine, site: str, *, batch: int = 2, seed: int = 0,
) -> tuple[bool, str]:
    """Dense shadow spot-check of one site's CURRENT operating point.

    Builds a fresh synthetic cache entry for the site's live spec (on the
    engine's device), feeds two consecutive integer-valued probe
    activations down the reuse path AND down a dense-oracle replica of the
    spec (exec_path="dense", no budget), and asserts the second outputs are
    bitwise equal — the telescoping invariant under the exact exec_path /
    block_k / max_active_k the serve loop is running. Returns (ok, detail).
    """
    from repro_torch.core.reuse_cache import init_site_cache
    from repro_torch.core.reuse_linear import reuse_linear

    spec = engine.sites[site]
    # integer probe codes must survive quantization exactly: scale=1 int8
    # quantization of small integers is the identity
    probe_spec = dataclasses.replace(spec, fixed_scale=1.0)
    oracle_spec = dataclasses.replace(
        probe_spec, exec_path="dense", max_active_k=None)
    x0, x1, w = _probe_operands(spec, batch, seed)
    device = engine.device or torch.device("cpu")
    wt = torch.from_numpy(w).to(device)

    def _run(sp):
        cache = init_site_cache(sp, batch, device=device)
        y = None
        for x in (x0, x1):
            y, cache, _ = reuse_linear(
                torch.from_numpy(x).to(device), wt, None, cache, sp,
                mode="reuse", impl=engine.impl,
            )
        return y.cpu().numpy()

    got = _run(probe_spec)
    want = _run(oracle_spec)
    if np.array_equal(got, want):
        return True, (f"bitwise-exact vs dense oracle "
                      f"(exec={spec.exec_path}, block_k={spec.block_k}, "
                      f"budget={spec.max_active_k})")
    diff = int(np.sum(got != want))
    return False, (f"{diff}/{got.size} output elements diverge from the "
                   f"dense oracle (exec={spec.exec_path}, "
                   f"block_k={spec.block_k}, budget={spec.max_active_k})")
