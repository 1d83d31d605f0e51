"""Serving CLI: continuous batching + ReuseSense decode, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
        --reduced --requests 4 --batch-slots 2 --max-new 6 --reuse --device cpu

Prefills each request into its slot lane, runs the shared decode step with
the reuse engine threaded through every linear site, prints one
`SensorReport rid=...` line per retired request and the per-site summary at
the end (and with `--sensor-jsonl PATH` appends the final report's rows to
PATH, the trace `python -m repro_torch.tune.fit` reads). `--device` defaults to `cuda`, where the engine runs the Hopper
kernels; on a machine without a card that default fails loudly instead of
falling back to the CPU. `--device cpu` runs the plain PyTorch versions.
`--impl jnp` builds the engine on the reference serve's tier (its "auto"
sites run the masked product "dense", the policy promotes to "compact").

`--control-every N` runs the online control plane (`repro_torch.control`)
every N decode steps: live per-site retuning, budget adaptation from the
measured overflow fallbacks, and the learned per-session admission
predictor, which places requests (`--control-journal PATH` appends every
decision to PATH; `python -m repro_torch.control.replay PATH` re-drives it).
`--affinity` without the controller places requests by a synthetic
prediction.

Fault containment (`repro_torch.guard`): with `--control-every` the
controller carries a QuarantineBreaker — the sentinel lanes ride the
breaker's ctrl snapshot, tripped lanes are pinned to basic and scrubbed,
transitions land in the decision journal as `kind="quarantine"` rows.
`--inject <scenario[:k=v,...]>` arms a deterministic fault (see
`repro_torch.guard.inject.SCENARIOS`: poison-nan, poison-sim, ctrl-garbage,
poison-counters, lying-telemetry, torn-journal, corrupt-ckpt, stall) at the
real seams, so a chaos run exercises the production wiring. Each decode step
is timed; the straggler watchdog feeds stall events into the same breaker.

The steps go through `serve/compiled_step.CompiledStep`: on the card each
prefill shape and each decode operating point (spec and mode signature) is
captured once as a CUDA graph over static buffers and replayed after;
`--eager` (the counterpart of `jax.disable_jit`) and `--device cpu` run the
same step functions directly. A step that builds a variant (runs the step
eagerly, then captures it) takes tens of replays' time, where the
reference's mode flips compile nothing; a quarantine and a re-admission are
mode flips. So the watchdog is fed only the steps that replayed or ran
directly (`CompiledStep.last_built`): a capture read as a stall would void
probation and move the breaker's lifecycle off the reference's. The
`decode loop:` line prices the serve per token over the same steps: each
step's decode plus the host work after it (a control interval, a mode
refresh, the injector).

Observability (`repro_torch.obs`): `--obs` turns on span tracing (a
`prefill` span per admission, a `serve_step` span per decode step, and
inside it the compiled step's span, its replay's device record on the
card, and the token's copy back) and a metrics registry for the run. The
spans stay in memory until the run ends, up to the trace module's cap
(262,144 records: about 52,000 decode steps on the card); the export line
says how many the cap turned away. `--obs-dir OUT` also exports `metrics.prom`
(Prometheus textfile), `metrics.jsonl` (snapshots for `python -m
repro_torch.obs.top`), `spans.jsonl`, and `latency_table.json` — the
measured per-(site, exec_path) latencies, probed at the run's measured skip
rates (on the card through CUDA graphs of each path; with `--eager`,
directly). Feed that table back with `--latency-table` (with
`--control-every`), or to `python -m repro_torch.tune.fit --latency-table`,
and break-even and exec decisions are priced from measured wall-clock.
`--profile-dir DIR` opens a `torch.profiler` window around the serve loop
and writes its Chrome trace to `DIR/trace.json`; the spans' ranges line up
with the device slices. `--replica-id ID` stamps every emitted row with
`replica=ID` for the fleet aggregator (`repro_torch.obs.fleet`).

Sharded serving: `--mesh host:N` (with `--reuse`) splits every reuse site
N-ways on the model axis (`ReuseEngine.shard_sites`): each shard keeps its
column panel's prev_out and a replica of every other cache leaf, and runs
its own kernels on its panel of the weight, read in place, on the serve's
one device (`host:N@S`: an S-wide model axis, the data axis replicated).
At startup it prints `mesh: {...} — N sites sharded S-way on the model
axis` and the no-gather line (one eager decode step on a copy of the state,
checked by `repro_torch.roofline.collectives`; a violation raises); at the
end `shard skip <site>: s0=... ` per site and `ici traffic: reduce=...
ctrl-writes=...`, the interconnect bytes the reference's mesh would move.

One shard a card: launched by `torchrun --nproc-per-node N -m
repro_torch.launch.serve ... --reuse --mesh host:N` (a process group up,
`launch/mesh.start_process_group`: NCCL on the card, each rank on
`cuda:LOCAL_RANK`; gloo with `--device cpu`), rank r holds model-axis
shard `r % S` of the reuse cache (`dist.shard.cache_shardings`), the
parameters and the decode state replicated, as the reference's
`device_put` places them; each sharded site call computes the rank's
panel and all-gathers the panels (`ReuseEngine.place`). A world size other
than N raises. Rank 0 alone prints, writes the control journal, the
sensor JSONL and the checkpoint; at exit every rank must have decoded the
same tokens. `--inject ...,shard=S` aims a cache fault at shard S's lane,
which rank S holds. `--obs-dir` and `--profile-dir` are not placed.
`--mesh prod` and `prod-pod` raise: they need 256 and 512 cards.

Checkpointing (`repro_torch.ckpt`): `--cache-ckpt DIR` (with `--reuse`)
restores the reuse cache from DIR's latest COMPLETE step at startup, in
place into the tensors `init_cache` built (so the compiled step's buffers
keep their addresses), rebuilds the mode mirrors from the restored mode
lanes and resolves the ctrl lanes against the tuned table
(`repro_torch.control.restore`: checkpoint < tuned table < live
controller, each resolution printed and journaled as `kind="restore"`).
At exit it saves the final cache at the batcher's step count, in the
reference's on-disk format; a sharded cache keeps its `[L, S, ...]`
layout (placed, rank 0 gathers the lanes outside the step and writes;
each rank restores its own lane in place). A corrupt newest step raises
`CorruptCheckpointError` at startup.

`run(cfg, args)` is the callable entry (chip_smoke.py drives it with a config
cut in depth); `main()` parses the flags and calls it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ReusePolicy
from repro_torch.core.reuse_cache import cache_bytes, map_tensors
from repro_torch.kernels import backend
from repro_torch.models import init_params
from repro_torch.obs import events
from repro_torch.obs import trace as obs_trace
from repro_torch.sensor.aggregate import slot_telemetry
from repro_torch.serve.compiled_step import CompiledStep, summary_line
from repro_torch.serve.scheduler import ContinuousBatcher, Request, reset_slot
from repro_torch.serve.serve_step import (
    build_reuse_engine,
    greedy_to_host,
    init_serve_state,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sensor-jsonl", default=None,
                    help="append the final SensorReport rows to this JSONL "
                    "file")
    ap.add_argument("--tuned-policy", default=None,
                    help="tuned-table JSON (the reference's repro.tune.fit "
                    "output format): per-site tunables, exec paths, budgets")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="re-run the host-side mode/exec-path policy every N "
                    "decode steps (0 = keep registration-time modes); "
                    "superseded by --control-every")
    ap.add_argument("--affinity", action="store_true",
                    help="place requests on slots by predicted stream "
                    "similarity instead of first-free")
    ap.add_argument("--control-every", type=int, default=0,
                    help="run the online control plane every N decode steps: "
                    "live per-site retuning, overflow-driven budget "
                    "adaptation and learned per-session admission; it runs "
                    "the mode refresh itself")
    ap.add_argument("--control-journal", default=None,
                    help="append the controller's decision journal (JSONL) "
                    "to this path for audit/replay")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; cuda runs the Hopper kernels")
    ap.add_argument("--impl", choices=("auto", "jnp"), default="auto",
                    help="the engine's tier: auto runs the Hopper kernels "
                    "on the card (the plain versions on the CPU); jnp is "
                    "the reference serve's tier, whose auto sites run "
                    "dense and whose promotions go to compact")
    ap.add_argument("--eager", action="store_true",
                    help="run each step directly instead of replaying its "
                    "CUDA graph")
    ap.add_argument("--obs", action="store_true",
                    help="enable the observability plane: perf_counter spans "
                    "around serve steps/prefills, correlation ids stamped on "
                    "sensor/journal rows, metrics aggregation")
    ap.add_argument("--replica-id", default=None,
                    help="fleet replica identity: stamp every emitted row's "
                    "trace block with replica=ID so a fleet aggregator "
                    "(repro_torch.obs.fleet) can join this replica's "
                    "streams; unset, emission is unchanged")
    ap.add_argument("--obs-dir", default=None,
                    help="export observability artifacts here (implies "
                    "--obs): metrics.prom, metrics.jsonl, spans.jsonl, and "
                    "latency_table.json (measured per-site/path latencies, "
                    "probed at the run's measured skip rates)")
    ap.add_argument("--profile-dir", default=None,
                    help="open a torch.profiler window around the serve "
                    "loop, writing its Chrome trace (trace.json) here")
    ap.add_argument("--latency-table", default=None,
                    help="measured latency table (a previous run's "
                    "--obs-dir/latency_table.json) for the online controller "
                    "— break-even/exec retunes are priced from measured "
                    "wall-clock; requires --control-every")
    ap.add_argument("--cache-ckpt", default=None,
                    help="reuse-cache checkpoint directory: restore the "
                    "latest step at start (ctrl-block precedence: checkpoint "
                    "< tuned table < live controller, resolutions journaled) "
                    "and save the final cache at exit; requires --reuse")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="shard the reuse serve along the model axis "
                    "(repro_torch.launch.mesh specs: 'host:N' makes N shards "
                    "of every site's cache and weight panel, on the serve's "
                    "one device, or one a card under torchrun "
                    "--nproc-per-node N; 'host:N@S' an S-wide model axis); "
                    "each shard runs its own kernels, no cache state crosses "
                    "shards in a step (checked at startup) and the sensor "
                    "counters cross the mesh once per control window; "
                    "requires --reuse")
    ap.add_argument("--inject", default=None, metavar="SCENARIO[:k=v,...]",
                    help="arm a deterministic fault scenario "
                    "(repro_torch.guard.inject.SCENARIOS) at the production "
                    "seams — e.g. poison-nan:at_step=12,site=mlp_in — for "
                    "chaos runs; requires --reuse")
    return ap


def run(cfg: ModelConfig, args: argparse.Namespace, *,
        after_step: Callable | None = None) -> dict:
    """Serve `args.requests` random-prompt requests on `cfg`. Returns
    {"done", "stats", "report", "engine", "rcache", "step", "seconds",
    "controller", "breaker", "injector", "registry", "latency_table",
    "profile"}: `step` is the CompiledStep, whose buffers hold the final
    state and cache; `controller` is the control plane's Controller and
    `breaker` its QuarantineBreaker (None without `--control-every`);
    `injector` the armed FaultInjector (None without `--inject`);
    `registry` the run's MetricsRegistry (None without `--obs`/`--obs-dir`),
    `latency_table` the table `--obs-dir` probed and `profile` the trace
    file `--profile-dir` wrote. `after_step(step_idx, step)` runs after each
    decode step, after the fault injection and the policy refresh or the
    control interval.

    The obs plane's process state (tracing on, its span buffer, the run
    and replica ids) lasts for the run and is put back as it was after
    it."""
    # the reference's argument errors, with its messages
    if cfg.family == "audio":
        raise ValueError("encoder archs have no decode path")
    for flag in ("sensor_jsonl", "tuned_policy", "refresh_every", "affinity",
                 "control_every", "control_journal", "cache_ckpt", "inject",
                 "mesh"):
        if getattr(args, flag) and not args.reuse:
            raise ValueError(f"--{flag.replace('_', '-')} requires --reuse")
    if args.control_journal and not args.control_every:
        raise ValueError("--control-journal requires --control-every")
    if args.latency_table and not args.control_every:
        raise ValueError("--latency-table requires --control-every")
    placed = None
    if args.mesh:
        from repro_torch.launch.mesh import start_process_group

        # under torchrun: one process a card (None: every shard here)
        placed = start_process_group(args.device)
        if placed is not None and (args.obs_dir or args.profile_dir):
            raise ValueError("--obs-dir and --profile-dir are not placed one "
                             "process a card: run them without torchrun")
    was_tracing = obs_trace.is_enabled()
    saved_ids = events.current_ids()
    try:
        with contextlib.ExitStack() as quiet:
            if placed is not None and placed[0] != 0:  # rank 0 alone prints
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            return _run(cfg, args, after_step, placed)
    finally:
        if not was_tracing:
            obs_trace.disable()
            obs_trace.drain_spans()
        events.clear_ids()
        events.set_ids(**saved_ids)


def _run(cfg: ModelConfig, args: argparse.Namespace,
         after_step: Callable | None, placed: tuple | None) -> dict:
    if args.control_every and args.refresh_every:
        print("--control-every supersedes --refresh-every "
              "(the controller runs the mode refresh itself)")
        args.refresh_every = 0
    obs_on = args.obs or bool(args.obs_dir)
    registry = None
    if obs_on:
        from repro_torch.obs.metrics import MetricsRegistry

        obs_trace.enable()
        run_id = events.new_run_id()
        events.set_ids(run=run_id)
        registry = MetricsRegistry()
        print(f"obs: tracing enabled, run={run_id}")
    if args.replica_id:
        # works with or without --obs: stamp() fires whenever any id is set,
        # so even a journal/sensor-only run carries its replica identity
        events.set_ids(replica=args.replica_id)
        print(f"obs: replica={args.replica_id}")
    device = backend.require_device(args.device)
    lead = placed is None or placed[0] == 0  # writes the run's files
    if placed is not None:
        device = placed[2]  # cuda:LOCAL_RANK
    # One shared journal: the restore-precedence pass (below) and the online
    # controller append to the same audit stream.
    journal = None
    if args.control_journal and lead:
        from repro_torch.control import DecisionJournal

        journal = DecisionJournal(args.control_journal)
    impl = (args.impl if args.impl != "auto"
            else "cuda" if device.type == "cuda" else "torch")
    print(f"kernel substrate: {backend.describe()} (serve impl={impl})")

    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, args.seed, device=device)
    state = init_serve_state(cfg, args.batch_slots, args.cache_len,
                             device=device)
    engine = None
    rcache = None
    mesh = None
    if args.reuse:
        policy = None
        if args.tuned_policy:
            from repro_torch.tune.table import load_tuned_policy

            policy = load_tuned_policy(args.tuned_policy)
            print(f"tuned policy: {len(policy.site_tunables)} site entries "
                  f"from {args.tuned_policy}")
        engine = build_reuse_engine(cfg, impl=impl, policy=policy)
        if args.mesh:
            from repro_torch.launch.mesh import mesh_axes, parse_mesh_spec

            mesh = parse_mesh_spec(args.mesh, device=str(device))
            ax = mesh_axes(mesh)
            planned = engine.shard_sites(ax["model_size"])
            print(f"mesh: {mesh.shape} — {len(planned)} sites sharded "
                  f"{ax['model_size']}-way on the model axis")
            if placed is not None:
                from repro_torch.launch.mesh import BACKENDS, place_mesh

                mesh = place_mesh(mesh, *placed)
                engine.place(mesh.placement)
                print(f"mesh placement: {placed[1]} ranks, one shard a card "
                      f"({BACKENDS[device.type]}); rank r holds shard r % "
                      f"{ax['model_size']} on {device.type}:LOCAL_RANK")
        rcache = engine.init_cache(args.batch_slots, device=device)
        print(f"reuse cache: {cache_bytes(rcache)/1e6:.2f} MB "
              f"({len(engine.sites)} sites)")
        for name, spec in engine.sites.items():
            budget = ("" if spec.max_active_k is None
                      else f"@{spec.max_active_k}")
            print(f"  site {name}: {spec.in_features}x{spec.out_features} "
                  f"dataflow={spec.dataflow} exec={spec.exec_path}{budget} "
                  f"block_k={spec.block_k}")
        if args.cache_ckpt:
            restore_cache_ckpt(args.cache_ckpt, engine, rcache, journal,
                               mesh=mesh)
        if args.tuned_policy:
            # tuned-vs-default delta: each site probed at full similarity
            # (the min-work admission decision), and the knobs that moved
            # off the global constants
            default = ReusePolicy()
            for name, spec in engine.sites.items():
                t = engine.policy.resolve(name)
                d_mode = default.decide_mode(spec, 1.0)
                t_mode = engine.policy.decide_mode(spec, 1.0)
                if (d_mode != t_mode
                        or abs(t.sim_threshold - default.sim_threshold) > 1e-9
                        or t.block_k is not None or t.exec_path is not None):
                    budget = (f"@{spec.max_active_k}"
                              if spec.max_active_k is not None else "")
                    print(f"  tuned delta {name}: mode@sim=1 {d_mode}->"
                          f"{t_mode} thr={t.sim_threshold:.3f} "
                          f"block_k={spec.block_k} "
                          f"exec={spec.exec_path}{budget}")

    if mesh is not None:
        no_gather_check(params, cfg, state, engine, rcache, mesh,
                        args.batch_slots)

    # Fault plane: the armed injector (chaos runs) plus the step clock the
    # straggler watchdog reads. Armed independently of the control plane — a
    # poisoned run WITHOUT the breaker is the useful negative control.
    injector = watchdog = None
    if args.inject:
        from repro_torch.guard import FaultInjector

        injector = FaultInjector.from_spec(args.inject)
        if engine is not None:
            injector.bind(engine)
        print(f"fault injection armed: {injector.scenario} "
              f"{injector.params} site={injector.site} "
              f"layer={injector.layer}")
    if engine is not None:
        from repro_torch.guard import StragglerWatchdog

        watchdog = StragglerWatchdog()

    # Learned admission and the online control plane: one shared journal;
    # the predictor learns per-session similarity from retirement telemetry
    predictor = controller = breaker = None
    if args.control_every > 0:
        from repro_torch.control import (
            AdmissionPredictor,
            ControlConfig,
            Controller,
        )
        from repro_torch.guard import QuarantineBreaker

        latency = None
        if args.latency_table:
            from repro_torch.obs.latency import (
                load_latency_table,
                table_provenance,
            )

            latency = load_latency_table(args.latency_table)
            print(f"controller pricing from measured latencies: "
                  f"{args.latency_table} ({len(latency)} rows)")
            prov = table_provenance(latency)
            if prov != "compiled":
                print(f"WARNING: latency table {args.latency_table} carries "
                      f"{prov} measurements — interpret-mode numbers run "
                      "20-80x off compiled reality; re-probe with a compiled "
                      "serve run (--obs-dir) before trusting its pricing")
                if journal is not None:
                    journal.note(
                        note="latency_table_provenance",
                        path=args.latency_table, provenance=prov,
                        meta=latency.meta,
                    )
        predictor = AdmissionPredictor()
        # the guard plane rides the controller cadence: sentinels are read
        # from the ctrl snapshot, containment decisions land in the same
        # journal stream, and the breaker's probation clock ticks in control
        # intervals
        breaker = QuarantineBreaker()
        controller = Controller(ControlConfig(), admission=predictor,
                                journal=journal, latency=latency,
                                guard=breaker)

    step = CompiledStep(params, cfg, state, batch=args.batch_slots,
                        engine=engine, rcache=rcache,
                        graphs=device.type == "cuda" and not args.eager,
                        log=print)

    # Batched-prefill simplification (as the reference): a slot's prefill
    # re-runs the batch prefill with the slot's prompt in its lane.
    def prefill_fn(prompt, slot):
        full = np.zeros((args.batch_slots, prompt.shape[1]), np.int32)
        full[slot] = prompt[0]
        logits = step.prefill(full)
        reset_slot(rcache, slot)
        return int(greedy_to_host(logits[slot:slot + 1, -1:])[0, 0])

    step_ms: list[float] = []
    step_built: list[bool] = []
    step_clock = {"step": 0}

    def decode_fn(tokens):
        step_clock["step"] += 1
        t0 = time.perf_counter()
        if injector is not None:
            # the stall scenario lives INSIDE the timed region — exactly
            # where a straggler host's slowness would land
            injector.maybe_stall(step_clock["step"])
        out = greedy_to_host(step.decode(np.asarray(tokens, np.int32)))
        dt = time.perf_counter() - t0
        step_ms.append(dt * 1e3)
        step_built.append(step.last_built)
        # a step that built its variant (eager run plus capture) is no
        # evidence of a straggler: the watchdog reads the other steps
        if watchdog is not None and not step.last_built:
            event = watchdog.observe(step_clock["step"], dt)
            if event is not None:
                print(f"straggler: step {event['step']} took "
                      f"{event['seconds']:.3f}s vs median "
                      f"{event['median']:.3f}s")
                if breaker is not None:
                    breaker.note_stall(event)
        return out

    # Lane similarity for --affinity without the controller: the hit rate
    # of the last stream that retired from the lane, snapshotted before the
    # lane is reset (with the controller, predictor.lane_character is it)
    lane_sim: dict[int, float] = {}
    telemetry_fn = on_retire = on_step = slot_sim_fn = None
    if engine is not None:
        def telemetry_fn(slot):
            return slot_telemetry(engine, rcache, slot)

        def on_retire(req):
            t = req.telemetry
            if predictor is None:
                lane_sim[req.slot] = t["hit_rate"]
            else:
                # learn BEFORE the reset clears the slot binding
                predictor.observe_retirement(req)
            print(f"SensorReport rid={req.rid} slot={t['slot']} "
                  f"steps={t['steps']} hit_rate={t['hit_rate']:.3f} "
                  f"sites={t['n_sites']}")
            reset_slot(rcache, req.slot, admission=predictor)

        if args.affinity:
            def slot_sim_fn(slot):
                return lane_sim.get(slot, 0.0)

    predict_sim_fn = on_place = None
    if controller is not None:
        predict_sim_fn = predictor.predict
        slot_sim_fn = predictor.slot_affinity
        on_place = predictor.on_placed

    refreshing = engine is not None and args.refresh_every > 0
    if refreshing or controller is not None or after_step is not None:
        def on_step(step_idx):
            # spec changes and mode flips change the decode key: the next
            # step captures a new variant, or replays the one of a known key
            if controller is not None and step_idx % args.control_every == 0:
                # the window id joins this interval's journal rows with the
                # records emitted while it was open
                with events.context(window=step_idx):
                    rep = controller.step(engine, rcache, step=step_idx)
                if registry is not None:
                    from repro_torch.obs.metrics import (
                        observe_control_report,
                        observe_guard_report,
                    )

                    observe_control_report(registry, rep)
                    if controller.last_guard_report is not None:
                        observe_guard_report(
                            registry, controller.last_guard_report)
                if rep.decisions:
                    print("\n".join(rep.summary_lines()))
            if refreshing and step_idx % args.refresh_every == 0:
                changed = engine.refresh_modes(rcache)
                if engine.last_mode_events:
                    flips = ", ".join(
                        f"{e['site']}"
                        + (f"@{e['layer']}" if e["layer"] is not None else "")
                        + f"->{e['after']}" for e in engine.last_mode_events)
                    print(f"mode refresh @step {step_idx}: {flips} (captures "
                          f"so far: {step.captures})")
                if changed:
                    print(f"exec refresh @step {step_idx}: {changed} "
                          f"(captures so far: {step.captures})")
            if after_step is not None:
                after_step(step_idx, step)

    if injector is not None:
        # chain the injector through the production seams: cache poisoning
        # lands post-decode (before the controller's next look), forged
        # telemetry rides the real retirement path
        base_on_step, base_telemetry = on_step, telemetry_fn

        def on_step(step_idx):
            n_fired = len(injector.fired)
            injector.on_cache_update(rcache, step_idx)
            if len(injector.fired) > n_fired:
                print(f"inject @step {step_idx}: "
                      f"{injector.fired[-1]['detail']}")
            if base_on_step is not None:
                base_on_step(step_idx)

        if base_telemetry is not None:
            def telemetry_fn(slot):
                return injector.on_telemetry(
                    base_telemetry(slot), step_clock["step"])

    # the host work between decode steps (control interval, mode refresh,
    # injector), timed per step beside the decode, with the tokens the step
    # emits (its active slots; they emit after the hook)
    hook_ms: list[float] = []
    step_tokens: list[int] = []
    inner_on_step = on_step

    def on_step(step_idx):
        step_tokens.append(len(batcher.active))
        t0 = time.perf_counter()
        if inner_on_step is not None:
            inner_on_step(step_idx)
        hook_ms.append((time.perf_counter() - t0) * 1e3)

    batcher = ContinuousBatcher(
        batch_slots=args.batch_slots,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        max_steps=args.requests * args.max_new + 8,
        telemetry_fn=telemetry_fn,
        on_retire=on_retire,
        slot_sim_fn=slot_sim_fn,
        on_step=on_step,
        predict_sim_fn=predict_sim_fn,
        on_place=on_place,
    )
    for i in range(args.requests):
        batcher.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, size=(args.prompt_len,),
                                dtype=np.int32),
            max_new_tokens=args.max_new,
            # without the controller, a synthetic prediction: traffic
            # alternates sticky-looking and one-shot-looking streams
            predicted_sim=(0.8 if i % 2 == 0 else 0.2)
            if (args.affinity and controller is None) else None,
            # two session classes for the learned predictor
            session=f"sess-{i % 2}" if controller is not None else None,
        ))
    if args.profile_dir:
        obs_trace.start_profile(args.profile_dir)
    t0 = obs_trace.now()  # perf_counter: monotonic wall-clock discipline
    done = batcher.run()
    dt = obs_trace.now() - t0
    profile = None
    if args.profile_dir:
        profile = obs_trace.stop_profile()
        if profile:
            print(f"device trace written to {profile}")
    print(f"served {len(done)}/{args.requests} requests in {dt:.2f}s; "
          f"{batcher.stats}")
    print(summary_line(step.summary()))
    loop_ms_per_token = None
    if step_ms:
        print(f"decode step: median {float(np.median(step_ms)):.2f} ms over "
              f"{len(step_ms)} steps (host clock to the tokens on the host)")
        replayed = [i for i, built in enumerate(step_built) if not built]
        tokens = sum(step_tokens[i] for i in replayed)
        if tokens:
            hooks = [hook_ms[i] for i in replayed]
            loop_ms_per_token = sum(step_ms[i] + hook_ms[i]
                                    for i in replayed) / tokens
            print(f"decode loop: {loop_ms_per_token:.3f} ms a token over the "
                  f"{len(replayed)} steps that built no variant ({tokens} "
                  f"tokens), each step's decode and the hooks after it "
                  f"(hooks {sum(hooks):.2f} ms in all, max {max(hooks):.2f})")
    report = None
    if engine is not None:
        report = engine.sensor_report(rcache)
        print("\n".join(report.summary_lines()))
        if engine.shards:
            # per-shard skip rates from one final cross-mesh snapshot (the
            # same [S] lanes the controller journals per window)
            snap = engine.ctrl_snapshot(rcache)
            for name in sorted(engine.shards):
                lanes = snap.get(name, {})
                if "skipped_shard" not in lanes:
                    continue
                sk = np.asarray(lanes["skipped_shard"], np.float64)
                cp = np.asarray(lanes["computed_shard"], np.float64)
                rates = sk / np.maximum(sk + cp, 1e-9)
                print(f"shard skip {name}: " + " ".join(
                    f"s{i}={r:.3f}" for i, r in enumerate(rates)))
            print(f"ici traffic: reduce={engine.ici_reduce_bytes/1e3:.1f} KB "
                  f"ctrl-writes={engine.ici_write_bytes/1e3:.1f} KB "
                  f"(priced at E_ICI in the sensor energy report)")
        if args.sensor_jsonl and lead:
            report.write_jsonl(args.sensor_jsonl)
            print(f"sensor report appended to {args.sensor_jsonl}")
    if controller is not None:
        n_dec = sum(len(r.decisions) for r in controller.reports)
        print(f"control plane: {len(controller.reports)} intervals, "
              f"{n_dec} decisions, admission {predictor.stats()}")
        if controller.journal is not None:
            print(f"decision journal: {controller.journal.rows_written} rows "
                  f"-> {controller.journal.path}")
    if breaker is not None:
        states = breaker.lane_states()
        lanes = ", ".join(
            f"{s}" + (f"@{l}" if l is not None else "") + f"={st}"
            for (s, l), st in sorted(states.items(),
                                     key=lambda kv: (kv[0][0], kv[0][1] or 0)))
        print(f"guard plane: {breaker.total_trips} sentinel trips, "
              f"{breaker.stall_windows} stall windows, "
              f"{breaker.quarantined_lanes()} lanes quarantined"
              + (f" [{lanes}]" if lanes else ""))
    if args.cache_ckpt and engine is not None:
        from repro_torch.ckpt.checkpoint import gather_cache, save_cache

        # the step's live buffers: rcache is the cache the graphs write;
        # placed, every rank's lanes gathered outside the step
        whole = gather_cache(engine, step.rcache)
        if lead:
            save_cache(args.cache_ckpt, batcher.stats["steps"], whole)
        print(f"cache checkpoint: saved step {batcher.stats['steps']} "
              f"to {args.cache_ckpt}")
        del whole
    if placed is not None:
        # every rank decoded the same tokens (and rank 0 has saved before
        # any rank's at-rest fault touches its files)
        digest = hashlib.sha256(repr(sorted(
            (r.rid, list(map(int, r.output))) for r in done)).encode()
        ).digest()
        if not engine.placement.world_agrees(digest):
            raise RuntimeError("the ranks of the placed serve decoded "
                               "different tokens")
        print(f"mesh placement: all {placed[1]} ranks decoded the same "
              "tokens")
    if injector is not None:
        # at-rest scenarios fire at exit, against the artifacts just written
        if args.control_journal and lead:
            injector.tear_journal(args.control_journal)
        if args.cache_ckpt and lead:
            injector.corrupt_checkpoint(args.cache_ckpt)
        print(f"fault injection: {len(injector.fired)} fault(s) fired")
        for ev in injector.fired:
            print(f"  {ev['scenario']} @step {ev['step']}: {ev['detail']}")
    table = None
    if args.obs_dir:
        from repro_torch.obs.export import write_jsonl, write_prometheus
        from repro_torch.obs.metrics import (
            observe_sensor_report,
            observe_spans,
        )

        os.makedirs(args.obs_dir, exist_ok=True)
        if engine is not None:
            # Probe measured latency per (site, exec_path), at the run's
            # MEASURED skip rates — the table --latency-table and
            # `repro_torch.tune.fit --latency-table` consume.
            from repro_torch.obs.latency import probe_latency_table

            skips = {s.site: s.tile_skip_rate for s in report.per_site}
            t_probe = time.perf_counter()
            table = probe_latency_table(
                engine, args.batch_slots, skip_rates=skips, device=device,
                graphs=step.graphs)
            lat_path = os.path.join(args.obs_dir, "latency_table.json")
            table.save(lat_path, meta={"arch": args.arch})
            print("\n".join(table.summary_lines()))
            print(f"measured latency table -> {lat_path} (probed in "
                  f"{time.perf_counter() - t_probe:.2f}s)")
            observe_sensor_report(registry, report)
        observe_spans(registry, obs_trace.spans())
        lost = obs_trace.dropped()
        n = write_prometheus(
            os.path.join(args.obs_dir, "metrics.prom"), registry)
        write_jsonl(os.path.join(args.obs_dir, "metrics.jsonl"), registry)
        n_spans = obs_trace.write_spans_jsonl(
            os.path.join(args.obs_dir, "spans.jsonl"))
        print(f"obs exports -> {args.obs_dir} (metrics.prom {n} lines, "
              f"metrics.jsonl, spans.jsonl {n_spans} spans, {lost} lost "
              "to the cap)")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return {"done": done, "stats": batcher.stats, "report": report,
            "engine": engine, "rcache": rcache, "step": step, "seconds": dt,
            "loop_ms_per_token": loop_ms_per_token, "hook_ms": hook_ms,
            "controller": controller, "breaker": breaker,
            "injector": injector, "registry": registry,
            "latency_table": table, "profile": profile}


def restore_cache_ckpt(directory: str, engine, rcache: dict,
                      journal, *, mesh=None) -> None:
    """`--cache-ckpt` at startup, as the reference: restore the latest
    COMPLETE step (`latest_step`: a corrupt newest step raises
    `CorruptCheckpointError`, it is not walked past) into the tensors
    `init_cache` built, rebuild the mode mirrors from the restored mode
    lanes, then resolve the ctrl precedence (journaled to `journal`).
    Placed (`mesh` placed one shard a card), each rank copies in its own
    lane of the one-device layout. Nothing without a checkpoint."""
    from repro_torch.ckpt.checkpoint import latest_step, restore_cache
    from repro_torch.control.restore import resolve_restored_ctrl

    ck_step = latest_step(directory)
    if ck_step is None:
        return
    shardings = None
    if mesh is not None and mesh.placement is not None:
        from repro_torch.dist.shard import cache_shardings

        shardings = cache_shardings(engine, mesh, rcache)
    restore_cache(directory, ck_step, rcache, shardings=shardings)
    if shardings is not None:
        engine.sync_mode_mirror(rcache)
    resolutions = resolve_restored_ctrl(engine, rcache, journal=journal,
                                        step=0)
    print(f"cache checkpoint: restored step {ck_step} from {directory}; "
          f"ctrl precedence resolved {len(resolutions)} lanes "
          f"(checkpoint < tuned table < live)")
    for d in resolutions:
        where = d.site + (f"@{d.layer}" if d.layer is not None else "")
        print(f"  restore {where} {d.field}: {d.before} -> {d.after}")


def no_gather_check(params, cfg: ModelConfig, state: dict, engine, rcache,
                    mesh, batch: int) -> dict:
    """The sharded serve's hot-path invariant, checked once at startup: one
    eager decode step, on copies of the decode state and the reuse cache,
    moves no reuse-cache state across shards — no collective on a cache
    leaf's signature or storage, and no copy, cat or gather of a signature
    (`repro_torch.roofline.collectives`); placed one shard a card, the
    step's all-gathers of output panels pass, as the reference's do.
    Raises on a violation; prints the line the reference prints for its
    HLO check, with the collectives and the KB a card gathers."""
    from repro_torch.dist.shard import (
        cache_shape_signatures,
        cache_shard_axes,
    )
    from repro_torch.roofline.collectives import (
        cache_collective_violations,
        cache_storages,
        collective_bytes,
        collective_count,
        trace_step,
    )
    from repro_torch.serve.serve_step import decode_step

    def copy(t):
        return t.clone() if isinstance(t, torch.Tensor) else np.array(t)

    probe_cache = map_tensors(copy, rcache)
    probe_state = map_tensors(copy, state)
    if mesh.placement is not None:
        # NCCL starts a communicator at its first collective: that one
        # runs here, outside the trace, which counts the step's own
        mesh.placement.all_gather(torch.zeros(1, device=state["len"].device))
    tokens = torch.zeros((batch, 1), dtype=torch.int32,
                         device=state["len"].device)
    trace = trace_step(lambda: decode_step(
        params, cfg, tokens, probe_state, engine=engine,
        reuse_cache=probe_cache))
    placed = mesh.placement is not None
    violations = cache_collective_violations(
        trace, cache_shape_signatures(
            rcache, cache_shard_axes(engine, mesh, rcache),
            n_shards=mesh.shape["model"] if placed else None),
        cache_storages(probe_cache))
    del probe_cache, probe_state
    if violations:
        raise RuntimeError(
            "sharded serve step gathers reuse-cache state across the mesh — "
            f"hot-path invariant violated: {violations}")
    print(f"profiler no-gather check: OK — 0 cache-touching gathers "
          f"({collective_count(trace)} collectives, "
          f"{collective_bytes(trace)/1e3:.1f} KB/card in one eager decode "
          f"step; {len(trace['moves'])} copies and gathers)")
    return trace


def close(res: dict) -> None:
    """End a serve that ran under a process group: its captured graphs,
    which hold the group's NCCL work, released first, then the group
    destroyed. Nothing without a group."""
    if torch.distributed.is_initialized():
        res["step"].release()
        torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = run(cfg, args)
    if args.mesh:
        close(res)


if __name__ == "__main__":
    main()
