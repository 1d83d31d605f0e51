"""Budget adapter — max_active_k from the measured overflow-fallback rate.

The port of `repro.control.budget`, whole. The compacted execution tier runs
a static k-extent budget; in the reference an evaluation whose live tile
count overflows it falls back to the full extent, which is always correct
but forfeits that step's grid-step saving. The port's ragged kernel walks
the live counts, so there the budget lives in the accounting
(`kernels/ops.ragged_grid_steps`, `ops.budget_overflow`), which counts the
reference's fallbacks; the sensor's `overflow_fallbacks` counter measures how
often one happens, so the budget becomes a closed-loop knob:

* **widen** when the windowed fallback rate exceeds `widen_fallback_rate` —
  each overflow costs a full gm·gn·gk walk, so a budget that trips often is
  worse than a looser one;
* **tighten** when a window ran fallback-free AND the measured occupancy
  (plus the policy's standard headroom) sits below the current budget — the
  stream got more similar, and every unused budget block is a grid step the
  kernel still walks. The controller additionally requires a STREAK of
  fallback-free windows (`ControlConfig.tighten_clean_windows`) before
  applying a tighten, and a much longer streak
  (`ControlConfig.tighten_floor_streak`) before re-entering a budget a
  previous widen recorded as overflowed — so a boundary-sitting stream
  can't ping-pong widen/tighten (each move is a new decode key: a capture
  of the compiled step, or a replay of a known one).

Both directions move ONE block per interval (bounded step: the next window
re-measures before moving again).
"""

from __future__ import annotations

from repro_torch.core.policy import ReusePolicy
from repro_torch.tune.trace import SiteTraceRecord


def adapt_budget(
    spec,
    win: SiteTraceRecord,
    *,
    n_layers: int,
    widen_fallback_rate: float,
) -> tuple[int, str] | None:
    """Proposed new max_active_k for one site from its window, or None.

    `n_layers` scales the per-step evaluation count for stacked sites (every
    layer slice's evaluation falls back independently)."""
    if spec.exec_path not in ("ragged", "compact") or spec.max_active_k is None:
        return None
    gk = -(-spec.in_features // spec.block_k)
    if win.block_k != spec.block_k:
        # the window was measured on a different tile grid (the retuner moved
        # block_k this interval); wait for a clean window
        return None
    evals = max(win.steps * max(n_layers, 1), 1)
    rate = win.overflow_fallbacks / evals
    budget = spec.max_active_k
    if rate > widen_fallback_rate and budget < gk:
        return budget + 1, (
            f"overflow_fallbacks {win.overflow_fallbacks}/{evals} evals "
            f"({rate:.0%}) > {widen_fallback_rate:.0%}"
        )
    if win.overflow_fallbacks == 0:
        want = ReusePolicy.ragged_budget(gk, win.tile_skip_rate)
        if want < budget:
            return budget - 1, (
                f"zero fallbacks, measured occupancy wants {want} "
                f"of {gk} blocks"
            )
    return None
