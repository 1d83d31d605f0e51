"""In-process N-replica serving harness — the fleet plane's test substrate.

    PYTHONPATH=src python -m repro_torch.launch.replicas --arch qwen3-32b \\
        --reduced --replicas 2 --out /tmp/fleet \\
        --inject poison-sim:at_step=24 --device cpu

The port of `repro.launch.replicas`. Runs N *independent* serving replicas
in one process: each replica owns its engine, reuse cache, compiled step
(`serve/compiled_step.CompiledStep`, the counterpart of the reference's
per-replica jit factory: on the card each decode key is captured once as a
CUDA graph and replayed, and a spec or mode change re-keys it), continuous
batcher, control plane (controller + admission predictor + quarantine
breaker), decision journal, metrics registry and obs dir — the per-process
state a real fleet member owns — while sharing the read-only model
parameters. The harness interleaves them round-robin via
`ContinuousBatcher.step_once`, wrapping every replica turn in
`events.context(run=..., replica=...)` so each row in each stream carries
its (run, replica) join keys, and drains the span buffer after each turn so
span attribution follows the same boundary.

Each replica gets a DISTINCT session mix (replica i cycles `2 + i` session
identities), so admission predictors learn different traffic and the fleet
view has real variance to show. `--inject` arms one replica (default: the
last) with a deterministic fault from `repro_torch.guard.inject` — the
chaos case the SLO watcher must attribute to THAT replica and no other.

While the replicas run, a `FleetAggregator` tails all the obs dirs live
(the same code path an out-of-process aggregator would use) and an
`SLOWatcher` evaluates after every poll. Outputs under `--out`:

    replica-<id>/{sensor,journal,spans,metrics}.jsonl + metrics.prom
    fleet_report.json    per-replica + fleet rollup (obs.fleet schema)
    alerts.jsonl         SLO alert rows (journal-style)
    fleet.prom           fleet_* gauges + fleet_alerts_total counters

`--device` defaults to `cuda` and fails loudly without a card; `--device
cpu` runs the plain PyTorch versions. `run(cfg, args)` is the callable
entry (a config cut in depth goes in there); `main()` parses the flags.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import backend
from repro_torch.models import init_params
from repro_torch.obs import events
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import (
    MetricsRegistry,
    observe_control_report,
    observe_guard_report,
    observe_sensor_report,
    observe_spans,
)
from repro_torch.sensor.aggregate import slot_telemetry
from repro_torch.serve.compiled_step import CompiledStep, summary_line
from repro_torch.serve.scheduler import ContinuousBatcher, Request, reset_slot
from repro_torch.serve.serve_step import (
    build_reuse_engine,
    greedy_sample,
    init_serve_state,
)


class Replica:
    """One serving replica's full per-process state, obs dir included."""

    def __init__(self, name: str, cfg, params, args, fleet_dir: str, *,
                 device: torch.device, graphs: bool, injector=None,
                 seed: int = 0):
        from repro_torch.control import (
            AdmissionPredictor,
            ControlConfig,
            Controller,
            DecisionJournal,
        )
        from repro_torch.guard import QuarantineBreaker

        self.name = name
        self.cfg = cfg
        self.params = params
        self.injector = injector
        self.run = events.new_run_id()
        self.obs_dir = os.path.join(fleet_dir, f"replica-{name}")
        os.makedirs(self.obs_dir, exist_ok=True)
        self.sensor_path = os.path.join(self.obs_dir, "sensor.jsonl")
        self.spans_path = os.path.join(self.obs_dir, "spans.jsonl")
        self.metrics_path = os.path.join(self.obs_dir, "metrics.jsonl")

        impl = "cuda" if device.type == "cuda" else "torch"
        self.engine = build_reuse_engine(cfg, impl=impl)
        self.rcache = self.engine.init_cache(args.batch_slots, device=device)
        self.registry = MetricsRegistry()
        self.journal = DecisionJournal(
            os.path.join(self.obs_dir, "journal.jsonl"))
        self.predictor = AdmissionPredictor()
        self.breaker = QuarantineBreaker()
        self.controller = Controller(
            ControlConfig(), admission=self.predictor, journal=self.journal,
            guard=self.breaker)
        state = init_serve_state(cfg, args.batch_slots, args.cache_len,
                                 device=device)
        self.step = CompiledStep(
            params, cfg, state, batch=args.batch_slots, engine=self.engine,
            rcache=self.rcache, graphs=graphs,
            log=lambda msg: print(f"[{name}] {msg}"))
        self.all_spans: list[dict[str, Any]] = []
        self.turn_s = 0.0
        self._control_every = args.control_every
        # repeat traffic: every stream in this replica loops one token (a
        # distinct one per replica), so consecutive decode steps feed
        # near-identical activations — the sticky-session reuse case, and
        # the steady skip baseline the SLO watcher judges collapses against.
        # random traffic exercises the no-reuse extreme instead.
        self.sticky_token = 7 + 4 * seed if args.traffic == "repeat" else None
        self.batcher = self._build_batcher(args)
        rng = np.random.default_rng(seed)
        for i in range(args.requests):
            if self.sticky_token is not None:
                prompt = np.full((args.prompt_len,), self.sticky_token,
                                 dtype=np.int32)
            else:
                prompt = rng.integers(0, cfg.vocab, size=(args.prompt_len,),
                                      dtype=np.int32)
            self.batcher.submit(Request(
                rid=i,
                prompt=prompt,
                max_new_tokens=args.max_new,
                # distinct session mix per replica: replica i cycles 2+i
                # session identities, so admission predictors diverge
                session=f"sess-{i % self._n_sessions}",
            ))

    @property
    def _n_sessions(self) -> int:
        return 2 + int(self.name.lstrip("r") or 0) \
            if self.name.startswith("r") else 2

    # --------------------------------------------------------- batcher wiring
    def _build_batcher(self, args) -> ContinuousBatcher:
        step, rcache, batch = self.step, self.rcache, args.batch_slots

        def prefill_fn(prompt, slot):
            full = np.zeros((batch, prompt.shape[1]), np.int32)
            full[slot] = prompt[0]
            logits = step.prefill(full)
            reset_slot(rcache, slot)
            return int(greedy_sample(logits[slot:slot + 1, -1:])[0, 0])

        def decode_fn(tokens):
            if self.injector is not None:
                self.injector.maybe_stall(self.batcher.stats["steps"] + 1)
            out = greedy_sample(step.decode(np.asarray(tokens, np.int32)))
            out = out.cpu().numpy()  # waits for the step
            if self.sticky_token is not None:
                # teacher-force the loop token: the whole decode ran (and
                # synced), only the emitted token is pinned so the stream
                # keeps repeating
                out = np.full_like(out, self.sticky_token)
            return out

        def telemetry_fn(slot):
            t = slot_telemetry(self.engine, rcache, slot)
            if self.injector is not None:
                t = self.injector.on_telemetry(
                    t, self.batcher.stats["steps"])
            return t

        def on_retire(req):
            self.predictor.observe_retirement(req)
            reset_slot(rcache, req.slot, admission=self.predictor)

        def on_step(step_idx):
            if self.injector is not None:
                n_fired = len(self.injector.fired)
                self.injector.on_cache_update(rcache, step_idx)
                if len(self.injector.fired) > n_fired:
                    print(f"[{self.name}] inject @step {step_idx}: "
                          f"{self.injector.fired[-1]['detail']}")
            if step_idx % self._control_every == 0:
                with events.context(window=step_idx):
                    rep = self.controller.step(self.engine, rcache,
                                               step=step_idx)
                    observe_control_report(self.registry, rep)
                    if self.controller.last_guard_report is not None:
                        observe_guard_report(
                            self.registry, self.controller.last_guard_report)
                    # one cumulative sensor snapshot per control window —
                    # the fleet plane's windowed-skip stream
                    self.engine.sensor_report(rcache).write_jsonl(
                        self.sensor_path)
                # a spec change or mode flip re-keys the compiled step: its
                # next decode captures, or replays a known variant

        return ContinuousBatcher(
            batch_slots=batch,
            prefill_fn=prefill_fn,
            decode_fn=decode_fn,
            max_steps=args.requests * args.max_new + 8,
            telemetry_fn=telemetry_fn,
            on_retire=on_retire,
            slot_sim_fn=self.predictor.slot_affinity,
            on_step=on_step,
            predict_sim_fn=self.predictor.predict,
            on_place=self.predictor.on_placed,
        )

    # ---------------------------------------------------------------- driving
    def turn(self) -> bool:
        """One interleaved scheduling turn, correlation-scoped to this
        replica; spans close inside the turn, so draining the (module-global)
        buffer here attributes them to the right replica."""
        if not self.batcher.pending:
            return False
        t0 = obs_trace.now()
        with events.context(run=self.run, replica=self.name):
            alive = self.batcher.step_once()
        self.turn_s += obs_trace.now() - t0
        drained = obs_trace.drain_spans()
        if drained:
            self.all_spans.extend(drained)
            with open(self.spans_path, "a") as f:
                for row in drained:
                    f.write(json.dumps(row) + "\n")
        return alive

    def finalize(self) -> None:
        """End-of-run emission, stamped with this replica's identity."""
        from repro_torch.obs.export import write_jsonl, write_prometheus

        with events.context(run=self.run, replica=self.name):
            report = self.engine.sensor_report(self.rcache)
            report.write_jsonl(self.sensor_path)
            observe_sensor_report(self.registry, report)
            observe_spans(self.registry, self.all_spans)
            write_prometheus(
                os.path.join(self.obs_dir, "metrics.prom"), self.registry)
            write_jsonl(self.metrics_path, self.registry)
        print(f"[{self.name}] run={self.run} "
              f"served={len(self.batcher.completed)} "
              f"steps={self.batcher.stats['steps']} "
              f"trips={self.breaker.total_trips} "
              f"quarantined={self.breaker.quarantined_lanes()}")
        tokens = self.batcher.stats["emitted_tokens"]
        print(f"[{self.name}] {tokens} tokens in {self.turn_s:.2f}s of its "
              f"turns ({tokens / max(self.turn_s, 1e-9):.1f} tokens/s); "
              f"{summary_line(self.step.summary())}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6,
                    help="requests submitted PER replica")
    ap.add_argument("--batch-slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--control-every", type=int, default=6,
                    help="control-plane (and sensor-window) cadence in "
                    "decode steps, per replica")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traffic", choices=("repeat", "random"),
                    default="repeat",
                    help="repeat: sticky streams looping one token per "
                    "replica (steady reuse, the skip baseline SLO collapse "
                    "is judged against); random: uncorrelated tokens "
                    "(the no-reuse extreme)")
    ap.add_argument("--out", required=True,
                    help="fleet dir: replica obs subdirs + fleet artifacts")
    ap.add_argument("--inject", default=None, metavar="SCENARIO[:k=v,...]",
                    help="arm a repro_torch.guard.inject scenario on ONE "
                    "replica (see --inject-replica)")
    ap.add_argument("--inject-replica", type=int, default=None,
                    help="replica index to arm --inject on (default: last)")
    ap.add_argument("--slo-collapse-frac", type=float, default=0.6)
    ap.add_argument("--slo-consecutive", type=int, default=2)
    ap.add_argument("--slo-min-baseline", type=float, default=0.05)
    ap.add_argument("--slo-p95-target", type=float, default=None)
    ap.add_argument("--baseline-windows", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the replicas run; cuda runs the Hopper "
                    "kernels")
    ap.add_argument("--eager", action="store_true",
                    help="run each step directly instead of replaying its "
                    "CUDA graph")
    return ap


def run(cfg: ModelConfig, args: argparse.Namespace, *, params=None) -> dict:
    """Run the fleet of `args.replicas` replicas on `cfg`. Returns
    {"replicas", "agg", "watcher", "alerts", "report", "seconds"}.
    `params` (weights to share instead of `init_params(cfg, args.seed)`,
    e.g. the reference's through `params_from_numpy`)."""
    from repro_torch.obs.export import write_prometheus
    from repro_torch.obs.fleet import FleetAggregator, export_fleet_metrics
    from repro_torch.obs.slo import SLOConfig, SLOWatcher
    from repro_torch.obs.stream import ReplicaStream

    if args.inject_replica is not None and not args.inject:
        raise ValueError("--inject-replica requires --inject")
    if cfg.family == "audio":
        raise ValueError("encoder archs have no decode path")
    inject_idx = None
    if args.inject:
        inject_idx = (args.replicas - 1 if args.inject_replica is None
                      else args.inject_replica)
        if not 0 <= inject_idx < args.replicas:
            raise ValueError(f"--inject-replica {inject_idx} out of range "
                             f"for --replicas {args.replicas}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda (the default) but no CUDA device is available;"
                " pass --device cpu to run the plain PyTorch versions")
        if backend.best() != "cuda":
            raise RuntimeError(
                f"the kernel substrate is {backend.best()!r}: the Hopper "
                "kernels need a device of capability 9.0 or newer")
    device = torch.device(args.device)
    graphs = device.type == "cuda" and not args.eager

    was_tracing = obs_trace.is_enabled()
    obs_trace.enable()
    try:
        os.makedirs(args.out, exist_ok=True)
        if params is None:
            params = init_params(cfg, args.seed, device=device)

        replicas: list[Replica] = []
        for i in range(args.replicas):
            injector = None
            if inject_idx == i:
                from repro_torch.guard import FaultInjector

                injector = FaultInjector.from_spec(args.inject)
                print(f"[r{i}] fault injection armed: {injector.scenario} "
                      f"{injector.params}")
            replicas.append(Replica(
                f"r{i}", cfg, params, args, args.out, device=device,
                graphs=graphs, injector=injector, seed=args.seed + i))
        print(f"fleet: {args.replicas} replicas, "
              + ", ".join(f"{r.name}=run:{r.run}" for r in replicas))

        # live fleet plane: tail the obs dirs the replicas are writing,
        # exactly as an out-of-process aggregator would
        fleet_registry = MetricsRegistry()
        agg = FleetAggregator(
            [ReplicaStream(r.obs_dir, replica=r.name) for r in replicas],
            baseline_windows=args.baseline_windows)
        watcher = SLOWatcher(
            agg,
            SLOConfig(
                collapse_frac=args.slo_collapse_frac,
                collapse_consecutive=args.slo_consecutive,
                min_baseline_skip=args.slo_min_baseline,
                p95_target_s=args.slo_p95_target,
            ),
            registry=fleet_registry,
            alerts_path=os.path.join(args.out, "alerts.jsonl"),
        )

        t0 = obs_trace.now()
        max_turns = args.requests * args.max_new + 16
        for turn in range(max_turns):
            alive = False
            for rep in replicas:
                alive = rep.turn() or alive
            if turn % args.control_every == 0 or not alive:
                agg.poll()
                for alert in watcher.evaluate():
                    print(f"SLO alert: {alert['alert_kind']} "
                          f"replica={alert['replica']} "
                          f"site={alert['site'] or '-'} {alert['detail']}")
            if not alive:
                break
        dt = obs_trace.now() - t0

        for rep in replicas:
            rep.finalize()

        # final drain: pick up the end-of-run sensor/metrics rows just written
        agg.poll(final=True)
        for alert in watcher.evaluate():
            print(f"SLO alert: {alert['alert_kind']} "
                  f"replica={alert['replica']} site={alert['site'] or '-'} "
                  f"{alert['detail']}")
        export_fleet_metrics(fleet_registry, agg)

        report = agg.fleet_report()
        report_path = os.path.join(args.out, "fleet_report.json")
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
        n_prom = write_prometheus(
            os.path.join(args.out, "fleet.prom"), fleet_registry)
        print("\n".join(agg.summary_lines()))
        print(f"fleet artifacts -> {args.out} (fleet_report.json, "
              f"alerts.jsonl {len(watcher.alerts)} alerts, fleet.prom "
              f"{n_prom} lines) in {dt:.2f}s")
    finally:
        if not was_tracing:
            obs_trace.disable()
    return {"replicas": replicas, "agg": agg, "watcher": watcher,
            "alerts": watcher.alerts, "report": report, "seconds": dt}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run(cfg, args)


if __name__ == "__main__":
    main()
