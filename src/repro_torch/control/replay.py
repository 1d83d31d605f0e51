"""Journal-driven replay — re-apply a decision journal, verify the trajectory.

    python -m repro_torch.control.replay journal.jsonl \
        [--arch qwen3-32b --reduced] [--device cpu]

The port of `repro.control.replay`: it reads journals written by either
package. A journal alone replays on any host, as the reference's does. With
`--arch` the engine's cache lives on the card unless `--device cpu` is
given, and that replay fails loudly without one.

A decision journal (`--control-journal` on the serving CLI) is the complete
causal record of a run's policy moves. Replay re-applies every decision row
IN ORDER to a fresh policy state and asserts the reproduced trajectory
matches the recorded one: each decision's `before` value must equal the state
the preceding decisions left behind (the first sight of a knob seeds it). A
mismatch means the journal is internally inconsistent — rows were lost,
reordered, or produced by something other than the journaled controller —
and replay exits non-zero naming the offending row.

With `--arch`, the decisions are ALSO driven through a real engine
(`build_reuse_engine` on the config, `--reduced` for the reduced one): retune rows through
`apply_tunables` (per-layer rows land as "site@layer" ctrl-lane writes),
budget rows through `set_budget`, mode rows through `set_mode` — proving the
journal is a sufficient script to reconstruct the serving run's final policy
on a fresh process, not just a log.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.control.report import load_journal

# One knob's trajectory is identified per decision KIND as well as field:
# "retune" rows track the policy-table entry while "budget"/"exec" rows track
# the installed spec — two stores that legitimately interleave (set_budget
# syncs the table, pins release), so chains are only verified within a kind.
# Journal v5 adds the shard scope: per-shard observation rows (kind="shard")
# chain independently per shard — a forged/misattributed shard id breaks its
# chain's before/after continuity and surfaces as a mismatch.
_KnobKey = tuple[str, str, str, Any, Any]  # (site, kind, field, layer, shard)

# (kind, field) chains with more than one writer: the budget adapter syncs
# the retuner's table entry between intervals, so the retune-side
# max_active_k chain is applied but not mismatch-checked.
_MULTI_WRITER = {("retune", "max_active_k")}
# A block_k retune rescales the INSTALLED budget (same covered K extent in
# the new units) and journals that as a retune row with this reason; the
# budget adapter's chain of the installed budget continues from it. The
# reference's replay keeps the two chains apart, so there the next budget
# row after a rescale reads as a mismatch (it shows once a budget moves
# before block_k does, as at full width).
_RESCALE_REASON = "rescaled with block_k"


@dataclasses.dataclass
class ReplayResult:
    n_rows: int
    n_decisions: int
    n_intervals: int
    # final value per knob after re-applying every decision in order
    final_state: dict[_KnobKey, Any]
    # rows whose `before` contradicted the reproduced trajectory
    mismatches: list[dict[str, Any]]
    # per-layer decisions seen (the stacked-site control surface)
    n_layer_scoped: int
    # per-shard observation rows seen (the sharded-mesh control surface)
    n_shard_scoped: int = 0

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def summary_lines(self) -> list[str]:
        lines = [
            f"replayed {self.n_decisions} decisions over "
            f"{self.n_intervals} intervals ({self.n_rows} rows); "
            f"{self.n_layer_scoped} layer-scoped; "
            f"{self.n_shard_scoped} shard-scoped; "
            f"{len(self.mismatches)} trajectory mismatches",
        ]
        for m in self.mismatches:
            lines.append(
                f"  MISMATCH {m['kind']}:{m['site']}.{m['field']}"
                + (f"@{m['layer']}" if m.get("layer") is not None else "")
                + (f"#s{m['shard']}" if m.get("shard") is not None else "")
                + f": journal before={m['before']!r} but replayed "
                f"state={m['replayed']!r} (interval {m['interval']})"
            )
        by_site: dict[str, list[str]] = {}
        for (site, kind, field, layer, shard), val in sorted(
            self.final_state.items(),
            key=lambda kv: tuple(str(p) for p in kv[0]),
        ):
            where = f"@{layer}" if layer is not None else ""
            if shard is not None:
                where = f"{where}#s{shard}"
            by_site.setdefault(site or "<model>", []).append(
                f"{kind}:{field}{where}={val}")
        for site, knobs in sorted(by_site.items()):
            lines.append(f"  final {site:24s} " + " ".join(knobs))
        return lines


def replay_rows(rows: list[dict[str, Any]]) -> ReplayResult:
    """Re-apply journal rows to a fresh knob-state map and verify each
    decision's `before` against the reproduced trajectory."""
    state: dict[_KnobKey, Any] = {}
    mismatches: list[dict[str, Any]] = []
    n_dec = n_int = n_layer = n_shard = 0
    for row in rows:
        kind = row.get("kind")
        if kind == "interval":
            n_int += 1
            continue
        if kind != "decision":
            continue
        n_dec += 1
        layer = row.get("layer")
        if layer is not None:
            n_layer += 1
        shard = row.get("shard")
        if shard is not None:
            n_shard += 1
        kind = row.get("decision_kind", "")
        field = row.get("field", "")
        key = (row.get("site", ""), kind, field, layer, shard)
        if (key in state and state[key] != row.get("before")
                and (kind, field) not in _MULTI_WRITER):
            mismatches.append(dict(
                site=key[0], kind=kind, field=field, layer=layer, shard=shard,
                before=row.get("before"), replayed=state[key],
                interval=row.get("interval"),
            ))
        state[key] = row.get("after")
        budget_key = (key[0], "budget", field, layer, shard)
        if (kind, field) == ("retune", "max_active_k") and budget_key in state \
                and str(row.get("reason", "")).startswith(_RESCALE_REASON):
            state[budget_key] = row.get("after")
    return ReplayResult(
        n_rows=len(rows), n_decisions=n_dec, n_intervals=n_int,
        final_state=state, mismatches=mismatches, n_layer_scoped=n_layer,
        n_shard_scoped=n_shard,
    )


def apply_to_engine(rows: list[dict[str, Any]], engine, cache) -> dict[str, Any]:
    """Drive the journal's decisions through a real engine + cache — the
    "fresh engine" half of replay. Returns {site: final spec/ctrl summary}
    for knobs the journal touched. Unknown sites (journal from a different
    arch) are skipped with a note under the "" key."""
    skipped: list[str] = []
    for row in rows:
        if row.get("kind") != "decision":
            continue
        site = row.get("site", "")
        if not site:
            continue  # model-level (admission) rows carry no engine knob
        if site not in engine.sites:
            skipped.append(site)
            continue
        kind, field = row.get("decision_kind"), row.get("field")
        layer = row.get("layer")
        after = row.get("after")
        if kind == "mode":
            engine.set_mode(cache, site, after, layer=layer)
        elif kind == "budget":
            engine.set_budget(site, int(after))
        elif kind in ("retune", "restore"):
            # "restore" rows record the startup checkpoint-vs-table
            # precedence resolution; their `after` is the value that won the
            # lane, so replaying them is the same table write as a retune.
            t = engine.policy.resolve(site, layer=layer)
            if field in {f.name for f in dataclasses.fields(t)}:
                t = dataclasses.replace(t, **{field: after})
                engine.apply_tunables(site, t, cache, layer=layer)
        elif kind == "exec":
            spec = engine.sites[site]
            budget = engine.policy.resolve_max_active_k(site)
            engine.sites[site] = dataclasses.replace(
                spec, exec_path=after, max_active_k=budget,
            )
        elif kind == "shard":
            # per-shard observation rows move no engine knob (skip decisions
            # are shard-LOCAL consequences of the global operating point);
            # replay chains them in replay_rows and applies nothing here
            pass
        elif kind == "quarantine" and field == "state":
            # containment transitions: entering quarantine pins the lane to
            # basic (the breaker's ctrl write); leaving it does NOT force
            # reuse — the hysteretic refresh re-promotes from recovered
            # sim_ema, so replay only reproduces the pin.
            if after == "quarantined":
                engine.set_mode(cache, site, "basic", layer=layer)
    out: dict[str, Any] = {}
    for name, spec in engine.sites.items():
        out[name] = dict(
            exec_path=spec.exec_path, block_k=spec.block_k,
            max_active_k=spec.max_active_k,
            modes=engine.layer_modes(cache, name),
        )
    if skipped:
        out[""] = f"skipped decisions for unknown sites: {sorted(set(skipped))}"
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Re-apply a control decision journal and assert the "
        "reproduced policy trajectory matches the recorded one."
    )
    ap.add_argument("journal", help="decision-journal JSONL path")
    ap.add_argument("--arch", default=None,
                    help="also drive the decisions through a fresh engine "
                    "for this architecture (e.g. qwen3-32b)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config for --arch")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the --arch engine's cache lives")
    args = ap.parse_args(argv)
    # a journal alone replays on any host; only an --arch engine needs the
    # device its cache lives on
    if args.arch and args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) but no CUDA device is available; "
            "pass --device cpu to replay on the CPU")

    rows = load_journal(args.journal)
    result = replay_rows(rows)
    print("\n".join(result.summary_lines()))

    if args.arch:
        from repro_torch.configs import get_config
        from repro_torch.serve.serve_step import build_reuse_engine

        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        engine = build_reuse_engine(
            cfg, impl="cuda" if args.device == "cuda" else "torch")
        cache = engine.init_cache(args.batch, device=args.device)
        summary = apply_to_engine(rows, engine, cache)
        for name, s in sorted(summary.items()):
            print(f"engine {name or '<note>'}: {s}")

    if not result.ok:
        print("REPLAY FAILED: journal trajectory is inconsistent")
        return 1
    print("replay OK: trajectory reproduced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
