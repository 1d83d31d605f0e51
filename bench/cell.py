"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result's line.

The system under test is the program's serve step: `CompiledStep.prefill`
and `CompiledStep.decode` (CUDA graph replays on the card) with the reuse
engine `serve_step.build_reuse_engine(cfg, impl="cuda")` at its
registration-time policy, wired as the program's serve CLI wires them:
greedy tokens go to the host after every step, and a new request's lane is
cleared with `scheduler.reset_slot`. The benchmark drives cohorts (see
`generator`); before a cohort's prefill it zeroes the decode state in place,
its length included, since the program keeps one length for the whole
batch.

Nothing here reads the program's spans or any file of the program: the
numbers come from this module's clock, the program's counters and the
device trace.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from bench import families, generator, weights
from bench import reference as ref

HERE = pathlib.Path(__file__).resolve().parent
# the modules whose presence after the window fails a run (whole top-level
# names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# decode steps of the traced stretch, and the cohort step it starts at
TRACE_STEPS = 32
TRACE_FROM = 33
# cohorts served in set-up after every shape is built: on the H100 a decode
# step runs ~7% slower (18.3 against 17.0 ms, nemotron4_15b.stream) for the
# first 3 to 12 s of sustained load, at the same reported clocks
WARM_COHORTS = 8
WARM_INDEX = 2**40


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the spec

@dataclasses.dataclass
class Spec:
    cell: str
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    end_to_end: list      # BENCHMARK.json's end-to-end metrics of the cell
    per_layer: list       # its per-layer metrics that list the cell
    limits: dict          # name → limit of each number compared
    check_cohorts: int    # finished cohorts the check samples (at most)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(root: pathlib.Path, workload: str) -> Spec:
    """Everything the cell `workload` names, found by name from
    `BENCHMARK.json`; an unknown name raises."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    sample = limits.pop("cohorts")
    return Spec(workload, conf, generator.check(mix),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                limits, sample)


def metric_reader(name: str):
    """The per-layer metric's reader, `metrics/<name>.py`'s `read(ctx)`."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------- the program

def port_config(conf: dict):
    """The program's ModelConfig of the configuration file: the registered
    arch with every size the file states (renamed by the family's
    `PORT_KEYS`); a size the program fixes in code (the family's
    `PORT_CONSTANTS`) has to equal the file's."""
    from repro_torch.configs import get_config

    fam = families.load(conf["reference"])
    base = get_config(conf["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    upd = {}
    for k, v in conf.items():
        k = fam.PORT_KEYS.get(k, k)
        if k in fields:
            upd[k] = v
    for key, (module, name) in fam.PORT_CONSTANTS.items():
        fixed = getattr(importlib.import_module(module), name)
        if fixed != conf[key]:
            raise ValueError(f"{key} {conf[key]} in the configuration, but "
                             f"the program fixes {module}.{name} = {fixed}")
    return dataclasses.replace(base, **upd)


class Program:
    """The program's serve step over static buffers, for one cell."""

    def __init__(self, conf: dict, mix: dict, params: dict, device):
        from repro_torch.serve.compiled_step import CompiledStep
        from repro_torch.serve.serve_step import (build_reuse_engine,
                                                  init_serve_state)

        self.cfg = port_config(conf)
        self.batch = mix["batch"]
        r = conf["reuse"]
        self.engine = build_reuse_engine(self.cfg, impl="cuda",
                                         block_m=r["block_m"],
                                         block_k=r["block_k"])
        for spec in self.engine.sites.values():
            if spec.fixed_scale != r["fixed_scale"]:
                raise ValueError(f"site {spec.name}: scale {spec.fixed_scale}"
                                 f" != the configuration's {r['fixed_scale']}")
        self.rcache = self.engine.init_cache(self.batch, device=device)
        self.state = init_serve_state(self.cfg, self.batch, mix["cache_len"],
                                      device=device)
        self.step = CompiledStep(params, self.cfg, self.state,
                                 batch=self.batch, engine=self.engine,
                                 rcache=self.rcache,
                                 graphs=torch.device(device).type == "cuda")

    def new_cohort(self) -> None:
        """Every lane cleared for a new cohort: the reuse lanes by the
        program's `reset_slot`, the decode state and its length zeroed in
        place."""
        from repro_torch.serve.scheduler import reset_slot

        for slot in range(self.batch):
            reset_slot(self.rcache, slot)
        _zero(self.state)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        from repro_torch.serve.serve_step import greedy_sample

        return greedy_sample(self.step.prefill(prompts))

    def decode(self, tokens: np.ndarray) -> torch.Tensor:
        return self.step.decode(tokens[:, None])

    def counters(self) -> dict[str, tuple[int, int]]:
        """site → (skipped tiles, computed tiles), summed over layers."""
        rep = self.engine.sensor_report(self.rcache)
        return {s.site: (s.skipped_tiles, s.computed_tiles)
                for s in rep.per_site}

    def release(self) -> None:
        self.step.release()
        self.step = self.engine = self.rcache = self.state = None


def _zero(tree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _zero(v)
    elif isinstance(tree, torch.Tensor):
        tree.zero_()


def greedy(logits: torch.Tensor) -> np.ndarray:
    from repro_torch.serve.serve_step import greedy_sample

    return greedy_sample(logits).cpu().numpy()[:, 0]


# ----------------------------------------------------------------- the run

@dataclasses.dataclass
class CohortRecord:
    cohort: generator.Cohort
    fed: np.ndarray        # [B, steps] tokens fed to the decode steps
    served: np.ndarray     # [B, steps + 1] the prefill's token, then each step's


def serve_cohort(prog: Program, c: generator.Cohort, steps: int, *,
                 deadline: float | None = None, clock=None):
    """One cohort: its prefill and up to `steps` decode steps, stopping after
    the step that ends past `deadline`. `clock` (a dict of lists) gathers
    the window's times. Returns the record, or None when the cohort was cut
    off by the deadline."""
    b = prog.batch
    prog.new_cohort()
    ev = None
    if clock is not None and clock.get("events"):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    tok = prog.prefill(c.prompts)
    if ev is not None:
        ev[1].record()
    served = [tok.cpu().numpy()[:, 0]]
    now = time.perf_counter()
    if clock is not None:
        clock["tokens"] += b
        if ev is not None:
            clock["prefill_events"].append(ev)
        if prog.step.last_built:
            log(f"capture inside the window: cohort {c.index} prefill")
    fed = []
    for t in range(1, steps + 1):
        feed = c.feed(t, served[-1])
        fed.append(feed)
        t0 = time.perf_counter()
        logits = prog.decode(feed)
        t1 = time.perf_counter()
        served.append(greedy(logits))
        t2 = time.perf_counter()
        if clock is not None:
            clock["host_ms"].append((t1 - t0) * 1e3)
            clock["gaps_ms"].extend([(t2 - now) * 1e3] * b)
            clock["tokens"] += b
            if prog.step.last_built:
                log(f"capture inside the window: cohort {c.index} step {t}")
        now = t2
        if deadline is not None and now >= deadline and t < steps:
            return None
    return CohortRecord(c, np.stack(fed, 1), np.stack(served, 1))


def warm_up(prog: Program, mix: dict, vocab: int, seed: int) -> None:
    """Every shape this cell's traffic uses, built before the window: one
    prefill graph a prompt length and the decode graph, each run again once
    it is built; then WARM_COHORTS cohorts of the cell's own traffic, so the
    window starts at the card's steady pace."""
    rng = np.random.default_rng(0)
    b = mix["batch"]
    for s in mix["prompt_lens"]:
        c = generator.Cohort(-1, rng.integers(0, vocab, (b, s)).astype(
            np.int32), np.zeros(b, np.int32), np.zeros((3, b), bool))
        serve_cohort(prog, c, 3)
        serve_cohort(prog, c, 3)
    for i in range(WARM_COHORTS):
        serve_cohort(prog, generator.cohort(mix, vocab, seed, WARM_INDEX + i),
                     mix["decode_steps"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def check_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden after the window."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def choose_cohorts(records: list[CohortRecord], seed: int, n: int) -> list:
    """The finished cohorts the reference checks: the first with the longest
    prompt, and up to n - 1 more drawn from the seed."""
    if not records:
        return []
    longest = max(records, key=lambda r: r.cohort.prompt_len)
    rest = [r for r in records if r is not longest]
    rng = np.random.default_rng([seed % 2**63, 7])
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def judge(params: dict, conf: dict, chosen: list, device,
          precisions=()) -> dict:
    """Over every served token of the chosen cohorts: the widest gap by
    which a served token's logit lies below the reference's best
    ("logit_gap") and the mean gap ("logit_gap_mean"). For each of
    `precisions` (keys of `reference.common.PRECISIONS`, such as the control
    "fp8"), the same two numbers of the tokens the reference computed in
    that precision puts first, on the same prompts and fed tokens."""
    worst = {"bf16": 0.0, **{p: 0.0 for p in precisions}}
    total = dict.fromkeys(worst, 0.0)
    tokens = 0
    for rec in chosen:
        c = rec.cohort
        seq = torch.as_tensor(np.concatenate([c.prompts, rec.fed], axis=1),
                              device=device)
        lg = ref.logits(params, conf, seq, c.prompt_len)
        picks = {"bf16": torch.as_tensor(rec.served)}
        for p in precisions:
            picks[p] = ref.logits(params, conf, seq, c.prompt_len,
                                  precision=p).argmax(dim=-1)
        for p, tok in picks.items():
            gaps = ref.served_gaps(lg, tok)
            worst[p] = max(worst[p], float(gaps.max()))
            total[p] += float(gaps.double().sum())
        tokens += rec.served.size
        del lg
    out = {"served_checked": tokens}
    for p in worst:
        tag = "" if p == "bf16" else f".{p}"
        out["logit_gap" + tag] = worst[p]
        out["logit_gap_mean" + tag] = total[p] / max(tokens, 1)
    return out


def compare(limits: dict, readings: dict,
            precision: str = "bf16") -> tuple[dict, bool]:
    """Each number compared beside its limit, from `judge`'s readings of the
    served tokens ("bf16") or of the tokens the reference in `precision`
    puts first (the control, "fp8"), and whether every one is within its
    limit."""
    tag = "" if precision == "bf16" else f".{precision}"
    check = {name: {"value": readings[name + tag], "limit": limit}
             for name, limit in limits.items()}
    return check, all(c["value"] <= c["limit"] for c in check.values())


def _percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def run(spec: Spec, seed: int, seconds: float, trace: bool, *, t_start: float,
        device="cuda", precisions=(), max_cohorts: int | None = None,
        program_hook=None) -> dict:
    """One run. Returns the result's fields ("check" last); `precisions`
    adds the readings of the reference computed in those precisions (the
    control's; never in a benchmark run). `max_cohorts` and
    `program_hook(prog)` are for tests on the CPU."""
    device = torch.device(device)
    conf, mix = spec.config, spec.traffic
    params = weights.make(conf, seed, device)
    prog = Program(conf, mix, params, device)
    if program_hook is not None:
        program_hook(prog)
    warm_up(prog, mix, conf["vocab"], seed)
    steps = mix["decode_steps"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = prog.counters() if trace else None
    clock = {"tokens": 0, "host_ms": [], "gaps_ms": [],
             "events": trace and device.type == "cuda", "prefill_events": []}

    # ------------------------------------------------------------ the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    records, index = [], 0
    while time.perf_counter() < deadline and (
            max_cohorts is None or index < max_cohorts):
        rec = serve_cohort(prog, generator.cohort(mix, conf["vocab"], seed,
                                                  index), steps,
                           deadline=None if max_cohorts else deadline,
                           clock=clock)
        index += 1
        if rec is not None:
            records.append(rec)
    window_s = time.perf_counter() - t0
    # ------------------------------------------------------- window closed

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = check_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    b = mix["batch"]
    out = {"attempted": len(records) * b, "failed": 0}
    metrics = {}
    if trace:
        ctx = traced(prog, spec, seed, index, before, clock)
        for m in spec.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = ctx.breakdown
        out["trace_device"] = {"busy_s": ctx.busy_s, "window_s": ctx.wall_s}
    else:
        e2e = {"decode_tok_s": clock["tokens"] / window_s,
               "itl_ms_p95": _percentile(clock["gaps_ms"], 95),
               "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    prog.release()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    chosen = choose_cohorts(records, seed, spec.check_cohorts)
    verdict = judge(params, conf, chosen, device, precisions)
    check, within = compare(spec.limits, verdict)
    ok = bool(chosen) and within
    out["failed"] = 0 if ok else len(chosen) * mix["batch"]
    out.update(correct=ok, metrics=metrics, peak=peak, window_s=window_s,
               cohorts=len(records), served_checked=verdict["served_checked"])
    out["readings"] = verdict
    out["check"] = check
    return out


def result_line(res: dict, trace: bool, *, kind: str, count: int) -> dict:
    """The result's line from `run`'s fields: the contract's keys, with
    "breakdown" in a traced run and "check" last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        device.update(res["trace_device"])
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    return line


# ------------------------------------------------------------ the trace

@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads."""

    conf: dict
    mix: dict
    host_ms: list          # host time of each window decode call
    prefill_ms: list       # device time of each window prefill (events)
    window_tiles: dict     # site → (skipped, computed) over the window
    stretch_tiles: dict    # site → (skipped, computed) over the stretch
    kernels: list          # (name, count, device seconds) in the stretch
    steps: int             # decode steps in the stretch
    wall_s: float          # the stretch's wall time
    busy_s: float          # seconds in which a device operation ran
    kv_len: float          # mean cached positions a stretch step attends
    breakdown: dict = dataclasses.field(default_factory=dict)

    def device_seconds(self, patterns) -> float | None:
        """Device seconds of the stretch's kernels whose name holds one of
        `patterns`; None when none ran."""
        hit = [s for n, _, s in self.kernels if any(p in n for p in patterns)]
        return sum(hit) if hit else None


def _diff(a: dict, b: dict) -> dict:
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in b}


def traced(prog: Program, spec: Spec, seed: int, index: int, before: dict,
           clock: dict) -> TraceContext:
    """After the window: its counters, and one more cohort whose decode
    steps TRACE_FROM .. TRACE_FROM + TRACE_STEPS - 1 run under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    conf, mix = spec.config, spec.traffic
    after = prog.counters()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prefill_ms = [e[0].elapsed_time(e[1]) for e in clock["prefill_events"]]
    c = generator.cohort(mix, conf["vocab"], seed, index)
    steps = mix["decode_steps"]
    first = min(TRACE_FROM, max(1, steps - TRACE_STEPS + 1))
    n = min(TRACE_STEPS, steps - first + 1)
    prog.new_cohort()
    served = prog.prefill(c.prompts).cpu().numpy()[:, 0]
    for t in range(1, first):
        served = greedy(prog.decode(c.feed(t, served)))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    s0 = prog.counters()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        w0 = time.perf_counter()
        for t in range(first, first + n):
            with record_function("bench.feed"):
                feed = c.feed(t, served)
            with record_function("bench.decode_call"):
                logits = prog.decode(feed)
            with record_function("bench.greedy_to_host"):
                served = greedy(logits)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    s1 = prog.counters()
    kernels = [(e.key, e.count, e.device_time_total / 1e6)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.device_time_total > 0 and not _annotation(e)]
    kernels.sort(key=lambda k: -k[2])
    evs = trace_events(prof)
    intervals = device_intervals(evs)
    busy = union_seconds(intervals)
    ctx = TraceContext(conf, mix, clock["host_ms"], prefill_ms,
                       _diff(before, after), _diff(s0, s1), kernels, n, wall,
                       busy, c.prompt_len + first - 1 + (n + 1) / 2)
    ctx.breakdown = {"device_ops": [[k[0][:120], k[2]] for k in kernels[:10]],
                     "idle_gaps": idle_gaps(evs, intervals)}
    return ctx


def _annotation(e) -> bool:
    """A `record_function` range, which the trace also lays on the device's
    timeline: no kernel."""
    name = getattr(e, "key", None) or e.name
    return bool(getattr(e, "is_user_annotation", False)
                or name.startswith("bench."))


def trace_events(prof) -> list:
    try:
        return list(prof.events())
    except Exception:  # a profile without events: no intervals, no gaps
        return []


def device_intervals(evs: list) -> list[tuple[int, int]]:
    """(start, end) in µs of every device operation among the trace's
    events, in order of start."""
    return sorted((e.time_range.start, e.time_range.end) for e in evs
                  if str(e.device_type).endswith("CUDA")
                  and not _annotation(e))


def union_seconds(intervals) -> float:
    """Seconds in which at least one operation ran: the union of the
    intervals (µs, in order of start), overlapping operations counted
    once."""
    total, start, end = 0.0, None, None
    for s, e in intervals:
        if end is not None and s > end:
            total += end - start
            start = None
        if start is None:
            start, end = s, e
        else:
            end = max(end, e)
    if start is not None:
        total += end - start
    return total / 1e6


def idle_gaps(evs: list, dev: list) -> list:
    """The device's idle time in the stretch (the gaps between the device
    intervals `dev`), by the host operation among the events `evs` that was
    running in the middle of each gap (the innermost: the latest to start
    of those still open), the ten largest totals."""
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                  if str(e.device_type).endswith("CPU"))
    gaps, end = [], None
    for s, e in dev:
        if end is not None and s > end:
            gaps.append(((s + end) / 2, (s - end) / 1e6))
        end = e if end is None else max(end, e)
    totals: dict[str, float] = {}
    active, i = [], 0
    for mid, sec in gaps:  # in time order: a sweep over the host's spans
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = active[-1][2] if active else "no host operation"
        totals[name] = totals.get(name, 0.0) + sec
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:10]
