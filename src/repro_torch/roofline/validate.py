"""Cross-validate the analytic cost model against counted work.

Two checks, as the reference's `repro.roofline.validate`:

* `validate(dir)` reads the reference's dry-run records (`*__decode_32k.json`
  with `status` and `cost_analysis.flops`, per-device FLOPs of a compiled
  decode step) and holds each against `predicted_decode_hlo_flops`:

      counted_flops  ≈  n_layers x analytic_per_layer_flops + head_flops

  Ratios near 1 confirm the model; deviations come from how the step was
  lowered (KV heads padded to the TP width, einsum lowering choices). On
  this package the same count comes from `torch.utils.flop_counter`.
* `validate_kernel_sweep(rows)` holds a measured skip-rate sweep of one
  reuse site against the kernel work model (`reuse_kernel_cost`).

    PYTHONPATH=src python -m repro_torch.roofline.validate DIR
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import math

from repro_torch.configs import ARCHS
from repro_torch.launch.specs import SHAPES
from repro_torch.roofline.model_cost import (
    POD_MESH,
    CellCost,
    _per_layer_forward,
    predict_kernel_speedup,
    predicted_break_even_skip,
)


def predicted_decode_hlo_flops(cfg, cell, mesh=POD_MESH) -> float:
    """Per-device FLOPs a compiled decode step of the cell should count
    (the full layer stack + the LM head)."""
    dp = mesh.dp * mesh.pods
    b_loc = max(cell.global_batch // dp, 1)
    block = CellCost()
    _per_layer_forward(cfg, mesh, cell.seq_len, b_loc, block,
                       kv_len=cell.seq_len, decode=True)
    body = block.flops * cfg.n_layers
    head = 2 * b_loc * cfg.d_model * cfg.vocab / mesh.tp
    return body + head


# Kernel-sweep validation. The work model prices flops + BALANCE-weighted
# bytes and deliberately omits dispatch/gather launch overhead, so on a
# measured sweep its absolute speedups are optimistic upper bounds and
# its break-even skip is a LOWER bound on the measured crossing. What the
# model does predict on any substrate — and what this validation gates on —
# is the payoff STRUCTURE:
#   rank        per compaction path, measured speedup must be monotone in
#               predicted speedup across the sweep (Spearman rank corr);
#   direction   outside a dead band around parity on BOTH sides, model and
#               measurement must agree on who wins;
#   break-even  one-sided: the measured compaction crossing may sit right
#               of the overhead-free prediction (or never arrive — the gate
#               then demotes to dense) but never LEFT of it: the model must
#               not claim compaction loses where measurement shows a win.
KERNEL_SWEEP_TOLERANCE = {
    # min Spearman rank correlation, predicted vs measured speedup, per
    # compaction path across skip levels
    "rank_corr_min": 0.6,
    # fraction of decided rows where the win/lose verdicts must match
    "direction_agreement_min": 0.7,
    # speedups within this factor of 1.0 (predicted OR measured) are
    # parity-adjacent: direction there is measurement noise, not signal
    "direction_dead_band": 0.15,
    # slack on the one-sided bound: measured_be >= predicted_be - slack
    "break_even_slack": 0.10,
}

# Paths whose work model is identical to dense (masking saves no compiled
# work): excluded from rank (zero predicted variance) and from the
# break-even, which is specifically the COMPACTION crossing.
_PARITY_PATHS = ("kernel", "masked", "masked_ref", "ref")


def _spearman(a: list[float], b: list[float]) -> float | None:
    def ranks(xs):
        order = sorted(range(len(xs)), key=lambda i: xs[i])
        out = [0.0] * len(xs)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
                j += 1
            for t in range(i, j + 1):
                out[order[t]] = (i + j) / 2.0
            i = j + 1
        return out

    if len(a) < 3:
        return None
    ra, rb = ranks(a), ranks(b)
    ma, mb = sum(ra) / len(ra), sum(rb) / len(rb)
    va = sum((x - ma) ** 2 for x in ra)
    vb = sum((y - mb) ** 2 for y in rb)
    if va == 0.0 or vb == 0.0:
        return None
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    return cov / math.sqrt(va * vb)


def validate_kernel_sweep(
    sweep_rows: list[dict], *, tolerance: dict | None = None
) -> dict:
    """A measured skip-rate sweep vs the kernel-level work model.

    `sweep_rows`: one dict per (skip, path) measurement with keys
    ``skip, path, us, m, k, n, block_m, block_k`` (``max_active_k`` for the
    budgeted paths); dense rows carry path ``dense_gemm``/``dense``.
    Returns a report with per-row predicted-vs-measured speedups, the three
    structural checks described above, the tolerance it validated against,
    and an overall ``ok``.
    """
    from repro_torch.tune.harvest import derive_break_even_skip

    tol = dict(KERNEL_SWEEP_TOLERANCE)
    if tolerance:
        tol.update(tolerance)
    dead = math.log1p(tol["direction_dead_band"])
    dense_us = {
        float(r["skip"]): float(r["us"])
        for r in sweep_rows if r["path"] in ("dense", "dense_gemm")
    }
    rows, agree, decided = [], 0, 0
    by_path: dict[str, list[tuple[float, float]]] = {}
    best_compaction: dict[float, float] = {}
    for r in sweep_rows:
        if r["path"] in ("dense", "dense_gemm"):
            continue
        skip = float(r["skip"])
        d_us = dense_us.get(skip)
        if d_us is None:
            continue
        measured = d_us / max(float(r["us"]), 1e-9)
        predicted = predict_kernel_speedup(
            int(r["m"]), int(r["k"]), int(r["n"]), path=r["path"], skip=skip,
            block_m=int(r.get("block_m", 8)), block_k=int(r["block_k"]),
            max_active_k=r.get("max_active_k"),
        )
        in_band = (abs(math.log(max(predicted, 1e-9))) < dead
                   or abs(math.log(max(measured, 1e-9))) < dead)
        row = {
            "skip": skip, "path": r["path"],
            "measured_speedup": measured, "predicted_speedup": predicted,
            "log_ratio": math.log(max(measured, 1e-9))
            - math.log(max(predicted, 1e-9)),
            "dead_band": in_band,
        }
        if not in_band:
            decided += 1
            row["direction_agree"] = (measured > 1.0) == (predicted > 1.0)
            agree += row["direction_agree"]
        rows.append(row)
        if r["path"] not in _PARITY_PATHS:
            by_path.setdefault(r["path"], []).append((predicted, measured))
            cur = best_compaction.get(skip)
            if cur is None or float(r["us"]) < cur:
                best_compaction[skip] = float(r["us"])

    rank_corr = {
        p: _spearman([x for x, _ in pts], [y for _, y in pts])
        for p, pts in sorted(by_path.items())
    }
    measured_corrs = [c for c in rank_corr.values() if c is not None]
    rank_ok = all(c >= tol["rank_corr_min"] for c in measured_corrs) \
        if measured_corrs else True

    points = [(s, best_compaction[s], dense_us[s])
              for s in sorted(best_compaction) if s in dense_us]
    measured_be = derive_break_even_skip(points) if points else 2.0
    compaction_rows = [r for r in sweep_rows
                       if r["path"] not in ("dense", "dense_gemm")
                       and r["path"] not in _PARITY_PATHS]
    if compaction_rows:
        ref = compaction_rows[0]
        predicted_be = min(
            predicted_break_even_skip(
                int(ref["m"]), int(ref["k"]), int(ref["n"]), path=p,
                block_m=int(ref.get("block_m", 8)),
                block_k=int(ref["block_k"]),
            )
            for p in {r["path"] for r in compaction_rows}
        )
    else:
        predicted_be = 2.0
    be_ok = measured_be >= predicted_be - tol["break_even_slack"]
    direction = agree / decided if decided else 1.0
    direction_ok = direction >= tol["direction_agreement_min"]
    return {
        "tolerance": tol,
        "rows": rows,
        "rank_correlation": rank_corr,
        "rank_ok": rank_ok,
        "measured_break_even_skip": measured_be,
        "predicted_break_even_skip": predicted_be,
        "break_even_within_tol": be_ok,
        "direction_agreement": direction,
        "direction_ok": direction_ok,
        "ok": rank_ok and be_ok and direction_ok,
    }


def validate(dryrun_dir: str) -> list[dict]:
    rows = []
    for path in sorted(Path(dryrun_dir).glob("*__decode_32k.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok" or not isinstance(
            rec.get("cost_analysis"), dict
        ):
            continue
        arch = rec["arch"]
        cfg = ARCHS[arch]
        pred = predicted_decode_hlo_flops(cfg, SHAPES["decode_32k"])
        hlo = rec["cost_analysis"].get("flops", 0.0)
        rows.append({
            "arch": arch,
            "hlo_flops": hlo,
            "predicted": pred,
            "ratio": hlo / pred if pred else float("nan"),
        })
    return rows


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: python -m repro_torch.roofline.validate DIR")
    rows = validate(argv[0])
    print(f"{'arch':24s} {'HLO flops':>14s} {'predicted':>14s} {'ratio':>7s}")
    for r in rows:
        print(f"{r['arch']:24s} {r['hlo_flops']:14.3e} "
              f"{r['predicted']:14.3e} {r['ratio']:7.2f}")


if __name__ == "__main__":
    main()
