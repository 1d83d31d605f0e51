"""Cycles + energy derived from MEASURED sensor counters.

Given a :class:`~repro_torch.sensor.aggregate.SensorReport` gathered from
real decode steps, derive the dynamic/static energy split and the
roofline-time speedup attributable to the measured skips — no assumed
similarity constant anywhere on this path. The port of
`repro.sensor.cost_model`, with the same functions and results.

The per-op energy constants (`E_MAC`, `E_HBM`, `E_ICI`, `STATIC_W`) are the
reference's modeled order-of-magnitude figures for a 7nm-class accelerator,
kept as they are so that the port's energy reports equal the reference's;
they are not H100 measurements. The roofline rates `sensor_speedup` divides
by (`PEAK_FLOPS`, `HBM_BW`) are the H100's datasheet figures
(`repro_torch.roofline.model_cost`), not the reference's TPU ones.
"""

from __future__ import annotations

from typing import Any

from repro_torch.roofline.model_cost import HBM_BW, PEAK_FLOPS

E_MAC = 0.3e-12      # J/FLOP (the reference's modeled bf16 MAC)
E_HBM = 12e-12       # J/byte HBM access (modeled)
E_ICI = 20e-12       # J/byte off-chip link (modeled)
STATIC_W = 80.0      # W per chip static/other (modeled)

FLOPS_PER_MAC = 2.0


def measured_skip_fractions(report) -> dict[str, float]:
    """The harvest actually achieved, straight from counters."""
    m = report.model
    return {
        "tile_skip_rate": m["tile_skip_rate"],
        "mac_skip_rate": m["mac_skip_rate"],
        "weight_byte_skip_rate": m["weight_byte_skip_rate"],
        "hit_rate": m["hit_rate"],
    }


def sensor_energy(report) -> dict[str, Any]:
    """Dynamic-energy accounting over the measured window (reuse-site scope).

    baseline  — what dense kernels would have spent on the instrumented
                sites: every MAC issued, every weight tile streamed;
    measured  — what the reuse kernels spent (computed MACs + issued weight
                traffic), plus the interconnect cost a model-sharded run
                pays (`ici_reduce_bytes`/`ici_ctrl_write_bytes`, priced at
                E_ICI; an unsharded report carries neither key);
    saved     — the skipped component net of that interconnect spend;
                ``reduction`` is saved/baseline.
    Static energy scales with step time, so its reduction follows the cycle
    model (`sensor_speedup`).
    """
    m = report.model
    get = m.get if hasattr(m, "get") else lambda k, d=0.0: getattr(m, k, d)
    base_flops = m["total_macs"] * FLOPS_PER_MAC
    base_bytes = m["total_weight_bytes"]
    saved_flops = m["skipped_macs"] * FLOPS_PER_MAC
    saved_bytes = m["skipped_weight_bytes"]
    ici_bytes = float(get("ici_reduce_bytes", 0.0)) \
        + float(get("ici_ctrl_write_bytes", 0.0))
    ici_j = ici_bytes * E_ICI
    base = base_flops * E_MAC + base_bytes * E_HBM
    saved = saved_flops * E_MAC + saved_bytes * E_HBM
    out = {
        "baseline_dynamic_j": base,
        "measured_dynamic_j": base - saved + ici_j,
        "saved_dynamic_j": saved - ici_j,
        "dynamic_reduction": (saved - ici_j) / max(base, 1e-30),
        "saved_flops": saved_flops,
        "saved_hbm_bytes": saved_bytes,
    }
    if ici_bytes:
        # additive keys, sharded runs only
        out["ici_bytes"] = ici_bytes
        out["ici_j"] = ici_j
    return out


def sensor_speedup(report) -> dict[str, Any]:
    """Roofline-time speedup on the instrumented sites from measured skips.

    Site GEMMs at decode shapes are memory-bound, so time ≈ max(flops/peak,
    bytes/bw); the measured variant subtracts the skipped components.
    """
    m = report.model
    base_flops = m["total_macs"] * FLOPS_PER_MAC
    base_bytes = m["total_weight_bytes"]
    live_flops = m["computed_macs"] * FLOPS_PER_MAC
    live_bytes = base_bytes - m["skipped_weight_bytes"]
    t_base = max(base_flops / PEAK_FLOPS, base_bytes / HBM_BW)
    t_meas = max(live_flops / PEAK_FLOPS, live_bytes / HBM_BW)
    return {
        "baseline_site_s": t_base,
        "measured_site_s": t_meas,
        "site_speedup": t_base / max(t_meas, 1e-30),
        "static_energy_reduction": 1.0 - t_meas / max(t_base, 1e-30),
    }
