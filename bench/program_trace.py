"""The program's own timeline of a decode stretch, read with no profiler
attached: what the `program_span` readers (`metrics/device_ms.decode.py`,
`host_wait_ms.step.py`, `site_ms.decode.py`, `site_epilogue_ms.decode.py`)
read from `ctx.program`.

`stretch(prog, spec, seed, index)` serves one cohort (generator index
`index`) with the program's tracing enabled (`repro_torch.obs.trace`): its
first decode steps capture the decode graph that holds the per-site timing
marks, and its decode steps TRACE_FROM .. TRACE_FROM + TRACE_STEPS - 1 (the
profiled stretch's) run through `CompiledStep.decode` and `greedy_to_host`,
alternating between the unmarked graph (the one every untraced step
replays) and the marked one: a mark drains the card's pipeline, so only
the unmarked replays time the step, and the marked replays time the sites.
Then tracing is disabled and the program's records are drained: the host
spans (`compiled_step.decode`, `serve.greedy_to_host`, `obs.resolve`), one
device record a replay (`compiled_step.decode.replay`: `dev_t0`, `dev_t1`
on the host's `perf_counter` clock, `marked`, and a marked replay's
per-site `marks`), and the count of records the program lost. A per-site,
per-phase table goes to standard error.

The stretch has to run before `cell.traced`: torch.profiler leaves CUPTI
attached to the process once CUDA graphs exist, and on the H100 a
nemotron4_15b decode call then takes ~1.6 ms more host time and its replay
~1.7 ms more device time. `cell.run` does not call it yet, so
`BENCHMARK.json` lists none of the four readers; `tools/trace_cost.py`
reads the same numbers in a process of its own.
"""

from __future__ import annotations

import time

from bench import cell, generator

DECODE_REPLAY = "compiled_step.decode.replay"
PHASES = ("quant", "product", "epilogue")


def stretch(prog, spec, seed: int, index: int) -> dict:
    """One more cohort (generator index `index`) under the program's
    tracing; the drained records of its decode steps TRACE_FROM ..
    TRACE_FROM + TRACE_STEPS - 1."""
    from repro_torch.obs import trace
    from repro_torch.serve.serve_step import greedy_to_host

    conf, mix = spec.config, spec.traffic
    c = generator.cohort(mix, conf["vocab"], seed, index)
    steps = mix["decode_steps"]
    first = min(cell.TRACE_FROM, max(1, steps - cell.TRACE_STEPS + 1))
    n = min(cell.TRACE_STEPS, steps - first + 1)
    trace.enable()
    try:
        prog.new_cohort()
        served = greedy_to_host(prog.step.prefill(c.prompts))[:, 0]
        for t in range(1, first + n):
            if t == first:
                trace.drain_spans()  # the marked graph's build, steps before
                w0 = time.perf_counter()
            trace.set_marks((t - first) % 2 == 1)
            served = greedy_to_host(prog.decode(c.feed(t, served)))[:, 0]
        wall = time.perf_counter() - w0
        rows, dropped = trace.drain_spans()
    finally:
        trace.disable()
    out = {"records": rows, "dropped": dropped, "steps": n, "wall_s": wall}
    for line in table(out):
        cell.log(line)
    return out


# ------------------------------------------------------------ the readings

def decode_replays(ctx, marked: bool | None = None) -> list | None:
    """The stretch's decode device records in time order (only the marked
    or only the unmarked replays, where `marked` says which); None where
    there are none, or where the program lost records."""
    prog = getattr(ctx, "program", None)  # the run sets it, where served
    if not prog or prog["dropped"]:
        return None
    reps = sorted((r for r in prog["records"] if r["name"] == DECODE_REPLAY
                   and marked in (None, r["marked"])),
                  key=lambda r: r["dev_t0"])
    return reps or None


def device_ms(reps: list) -> float:
    return 1e3 * sum(r["dev_t1"] - r["dev_t0"] for r in reps) / len(reps)


def host_wait_ms(reps: list, rows: list) -> float | None:
    """Mean gap from one replay's end to the next one's start, less the
    part of it in which an `obs.resolve` span was open."""
    if len(reps) < 2:
        return None
    resolves = [(r["t0"], r["t1"]) for r in rows if r["name"] == "obs.resolve"]
    total = 0.0
    for a, b in zip(reps, reps[1:]):
        lo, hi = a["dev_t1"], b["dev_t0"]
        total += hi - lo - sum(max(0.0, min(hi, t1) - max(lo, t0))
                               for t0, t1 in resolves)
    return 1e3 * total / (len(reps) - 1)


def phase_ms(reps: list) -> dict | None:
    """site → phase → device ms a marked replay, summed over the site's
    calls; None unless every replay of `reps` carries its marks."""
    if not reps or not all("marks" in r for r in reps):
        return None
    out: dict = {}
    for r in reps:
        for site, _, phase, ms in r["marks"]:
            by = out.setdefault(site, {})
            by[phase] = by.get(phase, 0.0) + ms / len(reps)
    return out


def site_ms(phases: dict, which=PHASES) -> float:
    """Device ms a replay inside the site calls' phases `which`, every site
    and layer (the LM head is no site)."""
    return sum(ms for site, by in phases.items() if site != "head"
               for phase, ms in by.items() if phase in which)


def table(prog: dict) -> list[str]:
    """The stretch's per-site, per-phase table (ms a step), and the step's
    parts beside its host period."""
    lines = [f"program trace: {prog['steps']} steps, "
             f"{len(prog['records'])} records, {prog['dropped']} lost, "
             f"host step period {1e3 * prog['wall_s'] / prog['steps']:.4f} ms"]
    reps = sorted((r for r in prog["records"] if r["name"] == DECODE_REPLAY),
                  key=lambda r: r["dev_t0"])
    plain = [r for r in reps if not r["marked"]]
    marked = [r for r in reps if r["marked"]]
    if not plain or not marked:
        return lines + [f"program trace: {len(plain)} unmarked and "
                        f"{len(marked)} marked device records"]
    dev, dev_marked = device_ms(plain), device_ms(marked)
    wait = host_wait_ms(reps, prog["records"])
    resolve = [r["dur_s"] * 1e3 for r in prog["records"]
               if r["name"] == "obs.resolve"]
    lines.append(f"program trace: device {dev:.4f} ms an unmarked replay "
                 f"({len(plain)}), {dev_marked:.4f} ms a marked one "
                 f"({len(marked)}); host wait "
                 f"{wait if wait is None else round(wait, 4)} ms; obs.resolve "
                 f"{sum(resolve) / len(reps):.4f} ms a step (widest "
                 f"{max(resolve, default=0.0):.4f})")
    phases = phase_ms(marked)
    if phases is None:
        return lines + ["program trace: marked replays without marks"]
    calls = {}
    for site, ordinal, _, _ in marked[0]["marks"]:
        calls[site] = max(calls.get(site, 0), ordinal + 1)
    lines.append("program trace: site calls/replay " + " ".join(
        f"{p:>9}" for p in PHASES) + "  (ms a marked step)")
    for site, by in phases.items():
        lines.append(f"program trace: {site:<14} {calls[site]:>5} " + " ".join(
            f"{by.get(p, 0.0):9.4f}" for p in PHASES))
    sites = site_ms(phases)
    epi = site_ms(phases, ("epilogue",))
    head = phases.get("head", {}).get("head", 0.0)
    lines.append(f"program trace: sites {sites:.4f} ms, epilogue {epi:.4f} ms,"
                 f" head {head:.4f} ms of a marked replay's {dev_marked:.4f}")
    return lines
