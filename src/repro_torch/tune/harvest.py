"""Shared break-even/harvest math — ONE cost model for offline and online.

The port of `repro.tune.harvest`. The offline fitter (`repro_torch.tune.fit`,
JSONL trace in) and an online retuner (the reference's
`repro_torch.control.retune`, live windowed counters in) must never
disagree on cost-model units: both feed a
:class:`~repro_torch.tune.trace.SiteTraceRecord` describing one measured
operating point into :func:`solve_site` and get the same
:class:`~repro_torch.core.policy.SiteTunables` back. The record is the
contract — offline it comes from a parsed trace row, online it is built
straight from counters (`record_from_sensor`) — and this module is the only
place the harvest model lives.

Per-step harvest model for one site (batch M, weights [K, N]):

    saved(r)  = g · r · (W_bytes · E_HBM  +  MACs · 2 · E_MAC)
    book      = (M·K·(x + prev_q + cur_q + delta)  +  M·N·(read + write O_p))
                · E_HBM

where r is the stream's code-hit rate, and g is the site's measured *harvest
efficiency* — the fraction of similarity the current tile granularity turns
into actually-skipped weight traffic (weight_byte_skip_rate / hit_rate).
The break-even hit rate r* solves saved(r*) = book; the fitted sim_threshold
is r* padded by a safety margin. Sites whose measured operating point is
net-positive get min_work_flops lowered to admit them; net-negative sites get
it raised to pin them basic. block_k steps down when g shows the granularity
is wasting similarity (tiles too coarse) and up when the harvest is already
saturated; churny sites (high mode_transitions/steps) get stiffer hysteresis.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.policy import (
    DEFAULT_MIN_WORK_FLOPS,
    RAGGED_BREAK_EVEN_SKIP,
    ReusePolicy,
    SiteTunables,
)
from repro_torch.sensor.cost_model import E_HBM, E_MAC, FLOPS_PER_MAC
from repro_torch.tune.trace import SiteTraceRecord

# Bookkeeping bytes per element, charged at HBM rates (conservative — much of
# this traffic stays on-chip): read x f32 + prev_q int8, write cur_q int8 +
# delta f32 per [M, K] element; read + write the f32 [M, N] prev_out panel.
BOOKKEEP_BYTES_PER_XK = 4.0 + 1.0 + 1.0 + 4.0
BOOKKEEP_BYTES_PER_MN = 4.0 + 4.0

BLOCK_K_CHOICES = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    safety_margin: float = 1.25     # threshold = margin × break-even hit rate
    min_threshold: float = 0.05
    max_threshold: float = 0.95
    # harvest-efficiency prior for sites with no measured reuse steps
    # (granularity.py measures 0.7-0.9 at block_k=256; stay conservative)
    prior_efficiency: float = 0.7
    low_efficiency: float = 0.5     # below: halve block_k (tiles too coarse)
    high_efficiency: float = 0.9    # above: double block_k (harvest saturated)
    churn_flip_rate: float = 0.10   # transitions/step above this = churny
    min_work_admit_factor: float = 0.5
    min_work_reject_factor: float = 2.0
    # Measured tile-skip rate above which the compacted execution tier
    # (ragged grid / gathered GEMM) is fitted instead of the masked walk.
    ragged_min_skip: float = RAGGED_BREAK_EVEN_SKIP
    # True fits "ragged" (the compacted-walk kernel, which the port runs);
    # False fits "compact" (the reference's jnp gather, which the port does
    # not run yet: a table naming it makes the port's serve raise).
    pallas_target: bool = False
    # Measured per-(site, layer, exec_path) wall-clock: a
    # `repro_torch.obs.latency.LatencyTable` (or the reference's: the JSON
    # cross-loads). When set, break-even hit rates,
    # net-positive admission, and exec-path pins are priced from these
    # MEASURED latencies instead of the energy-model constants above.
    latency: Any = None


def per_step_costs(rec: SiteTraceRecord) -> tuple[float, float, float]:
    """(dense weight bytes, dense MACs, bookkeeping joules) per evaluation."""
    steps = max(rec.steps, 1)
    gm = -(-rec.batch // rec.block_m)
    gk = -(-rec.in_features // rec.block_k)
    if rec.total_weight_bytes > 0:
        w_bytes = rec.total_weight_bytes / steps
    else:  # trace without byte totals: assume f32 weights on the padded grid
        w_bytes = gm * gk * rec.block_k * rec.out_features * 4.0
    if rec.total_macs > 0:
        macs = rec.total_macs / steps
    else:
        macs = gm * gk * rec.block_m * rec.block_k * rec.out_features
    book_j = (
        rec.batch * rec.in_features * BOOKKEEP_BYTES_PER_XK
        + rec.batch * rec.out_features * BOOKKEEP_BYTES_PER_MN
    ) * E_HBM
    return w_bytes, macs, book_j


def saved_per_step_j(w_bytes: float, macs: float, g: float, r: float) -> float:
    return g * r * (w_bytes * E_HBM + macs * FLOPS_PER_MAC * E_MAC)


def pick_block_k(rec: SiteTraceRecord, g: float, cfg: FitConfig) -> int:
    # Cap at the largest choice that doesn't exceed the (padded) K extent —
    # a block_k beyond K degenerates to all-or-nothing skipping.
    viable = [c for c in BLOCK_K_CHOICES if c <= rec.in_features]
    if not viable:
        return BLOCK_K_CHOICES[0]
    cur = min(viable, key=lambda c: abs(c - rec.block_k))
    idx = viable.index(cur)
    if g < cfg.low_efficiency and idx > 0:
        return viable[idx - 1]
    if g > cfg.high_efficiency and idx < len(viable) - 1:
        return viable[idx + 1]
    return cur


def measured_costs(rec: SiteTraceRecord, cfg: FitConfig,
                   g: float) -> dict[str, Any] | None:
    """Price the site from MEASURED wall-clock when `cfg.latency` covers it.

    The probe measures the basic-mode dense GEMM (`t_basic`) and each reuse
    substrate at the site's operating skip rate. The harvest model stays
    linear in hit rate, but in time units: t_reuse(r) = t_basic + t_book −
    g·r·t_basic. From the measured point (t_cur at the record's hit rate)
    the bookkeeping tax and break-even hit rate follow directly:

        t_book     = t_cur − t_basic + g·r_meas·t_basic
        r*         = t_book / (g·t_basic)
        net_s      = t_basic − t_cur     (reuse pays, measured, iff > 0)

    Returns None when the table lacks a basic baseline or any reuse path for
    this site — the caller falls back to the energy-model constants.
    """
    lat = cfg.latency
    if lat is None:
        return None
    basic = lat.stat(rec.site, "basic", layer=rec.layer)
    if basic is None or basic.mean_s <= 0.0:
        return None
    paths = {p: st for p, st in lat.paths_for(rec.site, layer=rec.layer).items()
             if p != "basic" and st.mean_s > 0.0}
    if not paths:
        return None
    cur_path = rec.exec_path if rec.exec_path in paths else \
        min(paths, key=lambda p: paths[p].mean_s)
    best_path = min(paths, key=lambda p: paths[p].mean_s)
    t_basic = basic.mean_s
    t_cur = paths[cur_path].mean_s
    t_book = t_cur - t_basic + g * rec.hit_rate * t_basic
    break_even = max(t_book, 0.0) / max(g * t_basic, 1e-12)
    return {
        "t_basic": t_basic,
        "t_cur": t_cur,
        "cur_path": cur_path,
        "t_book": t_book,
        "break_even": break_even,
        "net_s": t_basic - t_cur,
        "best_path": best_path,
        "t_best": paths[best_path].mean_s,
    }


def measured_latency_note(rec: SiteTraceRecord,
                          cfg: FitConfig) -> str | None:
    """Human-readable evidence string when a solve was priced from measured
    latencies — journaled with retune decisions so the journal records which
    decisions consumed measured (not constant) inputs."""
    measured_reuse = rec.tile_skip_rate > 0.0 or (
        rec.mode == "reuse" and rec.steps > 0
    )
    g = rec.harvest_efficiency if measured_reuse else 0.0
    if g <= 0.0:
        g = cfg.prior_efficiency
    meas = measured_costs(rec, cfg, g)
    if meas is None:
        return None
    return (
        f"measured basic={meas['t_basic'] * 1e6:.0f}us "
        f"{meas['cur_path']}={meas['t_cur'] * 1e6:.0f}us "
        f"r*={meas['break_even']:.2f}"
    )


def solve_site(rec: SiteTraceRecord, cfg: FitConfig = FitConfig()) -> SiteTunables:
    """Solve one site's tunables from its measured operating point."""
    w_bytes, macs, book_j = per_step_costs(rec)
    measured_reuse = rec.tile_skip_rate > 0.0 or (
        rec.mode == "reuse" and rec.steps > 0
    )
    g = rec.harvest_efficiency if measured_reuse else 0.0
    if g <= 0.0:
        g = cfg.prior_efficiency

    meas = measured_costs(rec, cfg, g)
    if meas is not None:
        # Measured pricing: break-even and admission from observed wall-clock.
        break_even = meas["break_even"]
    else:
        saveable_j = saved_per_step_j(w_bytes, macs, g, 1.0)
        if saveable_j <= 0.0:
            break_even = 1.0  # nothing to harvest; threshold clamps to max
        else:
            break_even = book_j / saveable_j
    sim_threshold = min(
        max(cfg.safety_margin * break_even, cfg.min_threshold),
        cfg.max_threshold,
    )

    # min_work: admit the site if its MEASURED operating point is net-positive
    # (harvest at the observed hit rate beats the bookkeeping), else pin it
    # basic — the per-site replacement for the one global small-layer cutoff.
    net_j = saved_per_step_j(w_bytes, macs, g, rec.hit_rate) - book_j
    net_positive = meas["net_s"] > 0.0 if meas is not None else net_j > 0.0
    if net_positive:
        min_work = min(DEFAULT_MIN_WORK_FLOPS,
                       cfg.min_work_admit_factor * rec.work_flops)
    else:
        min_work = max(DEFAULT_MIN_WORK_FLOPS,
                       cfg.min_work_reject_factor * rec.work_flops)

    flip_rate = rec.mode_transitions / max(rec.steps, 1)
    churny = flip_rate > cfg.churn_flip_rate or rec.suppressed_flips > 0

    # Execution substrate: above the break-even skip rate the compacted tier
    # converts the measured skip into elided grid steps / a shrunken GEMM.
    # The shrink scales with gk, so when promoting a site we also cap block_k
    # at a compactable granularity (gk >= 2); the budget is the measured
    # occupancy plus headroom (overflow steps fall back at runtime, so a
    # tight guess costs a fallback, never a wrong answer).
    block_k = pick_block_k(rec, g, cfg)
    exec_path: str | None = None
    max_active_k: int | None = None
    if meas is not None:
        # Measured gate: pin the compacted tier iff it actually measured
        # fastest for this site — the measured replacement for the constant
        # RAGGED_BREAK_EVEN_SKIP threshold (both promotion when the constant
        # gate would refuse, and demotion when it would promote a site whose
        # compacted path measures slower).
        promote = (measured_reuse and rec.tile_skip_rate > 0.0
                   and meas["best_path"] in ("ragged", "compact"))
    else:
        promote = (measured_reuse
                   and rec.tile_skip_rate >= cfg.ragged_min_skip)
    if promote:
        compactable = [c for c in BLOCK_K_CHOICES if 2 * c <= rec.in_features]
        if compactable:
            block_k = min(block_k, compactable[-1])
            gk = -(-rec.in_features // block_k)
            if meas is not None:
                exec_path = meas["best_path"]  # fastest MEASURED substrate
            else:
                exec_path = "ragged" if cfg.pallas_target else "compact"
            max_active_k = ReusePolicy.ragged_budget(gk, rec.tile_skip_rate)

    base = SiteTunables()
    return SiteTunables(
        sim_threshold=sim_threshold,
        min_work_flops=min_work,
        block_k=block_k,
        hysteresis_margin=base.hysteresis_margin * (2.0 if churny else 1.0),
        hysteresis_steps=base.hysteresis_steps * (2 if churny else 1),
        exec_path=exec_path,
        max_active_k=max_active_k,
    )


def derive_break_even_skip(points) -> float:
    """Measured break-even skip rate from a compiled skip-rate sweep.

    `points` is a sequence of (skip_rate, best_reuse_seconds, dense_seconds)
    triples — one per measured skip rate (the reference's compiled sweep,
    `benchmarks/wallclock.py`, emits them; on the card `chip_smoke.py`
    phase 8 does).
    Returns the skip rate where the best reuse path first matches the dense
    GEMM, linearly interpolating the crossing between the last losing and
    first winning sweep points. When reuse never wins, returns 2.0 — an
    unreachable gate, so `ReusePolicy(ragged_break_even_skip=...)` demotes
    every site to the masked/dense walk.
    """
    pts = sorted((float(s), float(r), float(d)) for s, r, d in points)
    if not pts:
        return RAGGED_BREAK_EVEN_SKIP
    margins = [(s, d - r) for s, r, d in pts]  # > 0 = reuse wins
    for i, (s, m) in enumerate(margins):
        if m >= 0.0:
            if i == 0:
                return s
            s0, m0 = margins[i - 1]
            if m == m0:
                return s
            t = -m0 / (m - m0)  # m0 < 0 <= m: crossing fraction in (0, 1]
            return s0 + t * (s - s0)
    return 2.0


def record_from_sensor(s, *, mode: str | None = None) -> SiteTraceRecord:
    """A solver-ready record from an in-memory SiteSensor — the JSONL-free
    equivalent of parsing the row `SensorReport.write_jsonl` would emit for
    it. Keeps the online path on exactly the offline contract."""
    return SiteTraceRecord(
        site=s.site,
        mode=mode if mode is not None else s.mode,
        steps=int(s.steps),
        batch=len(s.slot_steps),
        in_features=int(s.in_features),
        out_features=int(s.out_features),
        block_m=int(s.block_m),
        block_k=int(s.block_k),
        block_n=int(s.block_n),
        tile_skip_rate=float(s.tile_skip_rate),
        mac_skip_rate=float(s.mac_skip_rate),
        weight_byte_skip_rate=float(s.weight_byte_skip_rate),
        hit_rate=float(s.hit_rate),
        mode_transitions=int(s.mode_transitions),
        suppressed_flips=int(s.suppressed_flips),
        total_weight_bytes=float(s.total_weight_bytes),
        total_macs=float(s.total_macs),
        exec_path=str(s.exec_path),
        grid_steps=float(s.grid_steps),
        grid_step_skip_rate=float(s.grid_step_skip_rate),
        overflow_fallbacks=int(getattr(s, "overflow_fallbacks", 0)),
        layer=getattr(s, "layer", None),
        budget_occupancy=float(getattr(s, "budget_occupancy", 0.0)),
    )
