"""Checkpoint-vs-tuned-table restore precedence for the ctrl block.

The port of `repro.control.restore`. A restored serving state carries the
per-layer ctrl block (mode_id / sim_threshold / min_work / cooldown /
occupancy) from the moment the checkpoint was cut, and the process restoring
it may also have been launched with a tuned-policy table (`--tuned-policy`).
The order, enforced here once at restore time:

    checkpointed ctrl  <  tuned table  <  live controller state

* Lanes covered by a tuned-table row (site or "site@layer") are re-synced to
  the TABLE — the fitted numbers are newer intent than the checkpoint.
* Lanes with NO table row ADOPT the checkpointed values into the policy
  table, so the next `_sync_ctrl` (every retune runs one) re-derives the
  very same lanes instead of resetting them to defaults.
* The live controller then outranks both: it writes the table and the
  lanes on every interval.
* Dynamic state — mode_id, cooldown, occupancy — is never touched.

Every resolution is journaled as a kind="restore" Decision.

A site's two tunable lanes reach the host in one copy. A sharded site's
lanes are replicated over the shard axis (`ReuseEngine._site_lane`), so
shard 0's lane is the site's; one shard a card, shard 0's lane reaches
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.control.report import ControlReport, Decision, DecisionJournal
from repro_torch.core.policy import layer_key
from repro_torch.dist.shard import host_arrays, shard_axis_of

_REL_TOL = 1e-5


def _differs(a: float, b: float) -> bool:
    return not np.isclose(a, b, rtol=_REL_TOL, atol=0.0)


def _lanes(engine, name: str, ctrl: dict) -> tuple[np.ndarray, np.ndarray]:
    """(sim_threshold, min_work) per layer ([1] unstacked), f64 on the host
    (placed, shard 0's lane reaches every rank: one collective)."""
    both = torch.stack([ctrl["sim_threshold"], ctrl["min_work"]])
    ax = (1 + shard_axis_of(engine.stacking.get(name, 0))
          if engine.shards.get(name, 0) else None)
    [both] = host_arrays([both], [ax], getattr(engine, "placement", None))
    both = both.astype(np.float64)
    if ax is not None:
        both = np.take(both, 0, axis=ax)
    return np.atleast_1d(both[0]), np.atleast_1d(both[1])


def resolve_restored_ctrl(
    engine,
    cache: dict[str, Any],
    *,
    journal: DecisionJournal | None = None,
    step: int = 0,
) -> list[Decision]:
    """Enforce ctrl-block restore precedence on a just-restored cache.

    Writes the re-synced ctrl lanes in place (`engine._sync_ctrl`) and
    adopts checkpoint lanes into `engine.policy.site_tunables`; returns the
    journaled decisions. Call once, after the restore and before the first
    serve step."""
    decisions: list[Decision] = []
    table = engine.policy.site_tunables
    for name in engine.sites:
        entry = cache.get(name)
        if entry is None or "ctrl" not in entry:
            continue
        ck_thr, ck_mw = _lanes(engine, name, entry["ctrl"])
        stacked = engine.stacking.get(name, 0) > 0
        for lane in range(ck_thr.shape[0]):
            layer = lane if stacked else None
            row_key = layer_key(name, layer) if layer is not None else name
            covered = row_key in table or name in table
            resolved = engine.policy.resolve(name, layer=layer)
            pairs = (
                ("sim_threshold", float(ck_thr[lane]),
                 float(resolved.sim_threshold)),
                ("min_work_flops", float(ck_mw[lane]),
                 float(resolved.min_work_flops)),
            )
            if covered:
                # table wins: lanes re-sync below; journal real overrides
                for field, ck, tab in pairs:
                    if _differs(ck, tab):
                        decisions.append(Decision(
                            step=step, site=name, kind="restore", field=field,
                            before=ck, after=tab, layer=layer,
                            reason="tuned table overrides checkpointed ctrl "
                                   "lane (precedence: checkpoint < table "
                                   "< live)",
                        ))
            elif any(_differs(ck, tab) for _, ck, tab in pairs):
                # no table row: adopt the checkpointed operating point as a
                # policy row so later _sync_ctrl passes re-derive it instead
                # of resetting the lane to defaults
                adopt_key = layer_key(name, layer) if stacked else name
                table[adopt_key] = dataclasses.replace(
                    resolved,
                    sim_threshold=float(ck_thr[lane]),
                    min_work_flops=float(ck_mw[lane]),
                )
                for field, ck, tab in pairs:
                    if _differs(ck, tab):
                        decisions.append(Decision(
                            step=step, site=name, kind="restore", field=field,
                            before=tab, after=ck, layer=layer,
                            reason="no tuned row for this lane: adopted "
                                   "checkpointed ctrl value into the policy "
                                   "table (survives later ctrl syncs)",
                        ))
        # one sync per site makes the lanes consistent with the final table;
        # mode_id / cooldown / occupancy stay exactly as checkpointed
        engine._sync_ctrl(name, cache)
    if journal is not None and decisions:
        journal.append(ControlReport(
            step=step, interval=0, window_steps={},
            decisions=decisions, retrace={},
        ))
    return decisions
