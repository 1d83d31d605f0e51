"""Harvest-model fitter: measured sensor trace → per-site SiteTunables.

The port of `repro.tune.fit`: it reads the measured per-site skip rates out
of a sensor trace and solves, per site, for the knobs `ReusePolicy`
consults. The solve lives in :mod:`repro_torch.tune.harvest`; this module is
the offline front door, trace in, tuned table out:

    python -m repro_torch.tune.fit --trace trace.jsonl --out tuned.json \\
        [--safety-margin F] [--prior-efficiency F] [--pallas-target] \\
        [--site-only] [--latency-table latency_table.json]

On the card pass `--pallas-target`: it fits "ragged" (the compacted-walk
kernel the port runs) for high-skip sites, where the default fits the
reference's jnp "compact" path, which the port's serve does not run yet.
`--latency-table` (a `serve --obs-dir` run's `latency_table.json`, from
either package) prices break-even, admission and exec pins from measured
wall-clock instead of the energy-model constants.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.policy import SiteTunables, layer_key
from repro_torch.tune.harvest import (
    BLOCK_K_CHOICES,
    BOOKKEEP_BYTES_PER_MN,
    BOOKKEEP_BYTES_PER_XK,
    FitConfig,
    solve_site,
)
from repro_torch.tune.trace import SiteTraceRecord, Trace

__all__ = [
    "BLOCK_K_CHOICES",
    "BOOKKEEP_BYTES_PER_MN",
    "BOOKKEEP_BYTES_PER_XK",
    "FitConfig",
    "fit_layer",
    "fit_site",
    "fit_trace",
    "summary_lines",
]


def fit_site(rec: SiteTraceRecord, cfg: FitConfig = FitConfig()) -> SiteTunables:
    """Solve one site's tunables from its measured operating point (thin
    offline wrapper over the shared harvest model)."""
    return solve_site(rec, cfg)


def fit_layer(rec: SiteTraceRecord, cfg: FitConfig = FitConfig()) -> SiteTunables:
    """Solve ONE LAYER's tunables row from its per-layer trace slice.

    Same harvest model as the site fit, but spec-level knobs (block_k /
    exec_path / max_active_k) are stripped: those are baked into the step at
    SITE granularity, while a layer row only drives the per-layer ctrl lanes
    (sim_threshold / min_work / hysteresis)."""
    return dataclasses.replace(
        solve_site(rec, cfg),
        block_k=None, exec_path=None, max_active_k=None,
    )


def fit_trace(
    trace: Trace, cfg: FitConfig = FitConfig(), *, per_layer: bool = True
) -> dict[str, SiteTunables]:
    """Per-site tunables from a trace; with `per_layer` (default), stacked
    sites' layer rows additionally fit "site@layer" keyed rows."""
    table = {
        name: fit_site(rec, cfg) for name, rec in sorted(trace.sites.items())
    }
    if per_layer:
        for name, by_layer in sorted(trace.layers.items()):
            if len(by_layer) < 2:
                continue  # a 1-layer "stack" has nothing layer-specific
            for layer, rec in sorted(by_layer.items()):
                table[layer_key(name, layer)] = fit_layer(rec, cfg)
    return table


def summary_lines(
    trace: Trace, tunables: dict[str, SiteTunables]
) -> list[str]:
    default = SiteTunables()
    n_layer_rows = sum(name not in trace.sites for name in tunables)
    lines = [
        f"fitted {len(tunables) - n_layer_rows} sites "
        f"(+{n_layer_rows} per-layer rows) from {trace.n_rows} rows "
        f"({trace.path})",
        f"{'site':24s} {'thr':>6s} {'blk_k':>6s} {'exec':>8s} {'min_work':>10s} "
        f"{'hit':>5s} {'eff':>5s}  vs default",
    ]
    for name, t in tunables.items():
        if name not in trace.sites:
            continue  # "site@layer" rows: summarized by the count above
        rec = trace.sites[name]
        diffs = []
        if abs(t.sim_threshold - default.sim_threshold) > 1e-9:
            diffs.append(f"thr {default.sim_threshold:.2f}->{t.sim_threshold:.2f}")
        if t.block_k != rec.block_k:
            diffs.append(f"block_k {rec.block_k}->{t.block_k}")
        if t.exec_path is not None:
            budget = f"@{t.max_active_k}" if t.max_active_k is not None else ""
            diffs.append(f"exec {rec.exec_path}->{t.exec_path}{budget}")
        if t.min_work_flops != default.min_work_flops:
            diffs.append(f"min_work {default.min_work_flops:.2e}->"
                         f"{t.min_work_flops:.2e}")
        lines.append(
            f"{name:24s} {t.sim_threshold:6.3f} {t.block_k!s:>6s} "
            f"{t.exec_path or 'auto':>8s} "
            f"{t.min_work_flops:10.3e} {rec.hit_rate:5.2f} "
            f"{rec.harvest_efficiency:5.2f}  {'; '.join(diffs) or 'unchanged'}"
        )
    return lines


def main() -> None:
    import argparse

    from repro_torch.tune.table import save_table
    from repro_torch.tune.trace import load_trace

    ap = argparse.ArgumentParser(
        description="Fit per-site ReusePolicy tunables from a sensor trace "
        "(serve with --sensor-jsonl, fit, serve with --tuned-policy)."
    )
    ap.add_argument("--trace", required=True, help="sensor JSONL trace path")
    ap.add_argument("--out", required=True, help="tuned-table JSON output path")
    ap.add_argument("--safety-margin", type=float,
                    default=FitConfig.safety_margin)
    ap.add_argument("--prior-efficiency", type=float,
                    default=FitConfig.prior_efficiency)
    ap.add_argument("--latency-table", default=None,
                    help="measured per-(site, layer, exec_path) latency "
                    "table (serve --obs-dir writes one); when given, "
                    "break-even / admission / exec pins are priced from "
                    "measured wall-clock instead of energy-model constants")
    ap.add_argument("--pallas-target", action="store_true",
                    help="fit the compacted-walk kernel (exec_path='ragged', "
                    "the path the port runs) for high-skip sites instead of "
                    "the reference's jnp gather path ('compact')")
    ap.add_argument("--site-only", action="store_true",
                    help="fit site-granular rows only; by default stacked "
                    "sites' per-layer trace rows also fit 'site@layer' "
                    "tunables rows (per-layer ctrl-lane thresholds)")
    args = ap.parse_args()

    latency = None
    if args.latency_table:
        from repro_torch.obs.latency import (
            load_latency_table,
            table_provenance,
        )

        latency = load_latency_table(args.latency_table)
        print(f"pricing from measured latencies: {args.latency_table} "
              f"({len(latency)} rows)")
        prov = table_provenance(latency)
        if prov != "compiled":
            print(f"WARNING: latency table {args.latency_table} carries "
                  f"{prov} measurements — interpret-mode numbers price the "
                  "fit 20-80x off compiled reality; re-probe with a compiled "
                  "serve run (--obs-dir) before trusting the fitted table")
    cfg = FitConfig(safety_margin=args.safety_margin,
                    prior_efficiency=args.prior_efficiency,
                    pallas_target=args.pallas_target,
                    latency=latency)
    trace = load_trace(args.trace)
    tunables = fit_trace(trace, cfg, per_layer=not args.site_only)
    print("\n".join(summary_lines(trace, tunables)))
    save_table(args.out, tunables,
               meta={"trace": args.trace, "n_rows": trace.n_rows})
    print(f"tuned table written to {args.out}")


if __name__ == "__main__":
    main()
