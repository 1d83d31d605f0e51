"""What the program's own tracing costs on the card: decode tokens a second
of one benchmark cell's program, served in turns with tracing off, on
without marks, on with marks every other step (as `bench/program_trace.py`
serves its stretch) and on with marks every step, each turn one cohort's
decode steps; plus, in the traced turns, the `obs.resolve` host ms a step,
the host step period, and the `program_span` readings as
`bench/program_trace.py` computes them (device ms of an unmarked replay,
the host wait between replays, the marked replays' per-site, per-phase
ms), here with no profiler run in the process before. Run from the repository root on a machine with a card:

    python3 tools/trace_cost.py --workload rwkv6_7b.chat --seed 7 \
        [--rounds 4] [--steps 64]

Prints one line a turn and, last, one JSON line of medians a mode."""

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import cell, generator, program_trace, weights  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve.serve_step import greedy_to_host  # noqa: E402

MODES = ("off", "on", "alternate", "marks")


def serve_turn(prog, mix, vocab, seed, index, steps, mode):
    """One cohort: its prefill untimed, then `steps` decode steps timed in
    `mode`. Returns (tokens a second, records, lost records)."""
    c = generator.cohort(mix, vocab, seed, index)
    prog.new_cohort()
    served = greedy_to_host(prog.step.prefill(c.prompts))[:, 0]
    if mode != "off":
        trace.enable()
    try:
        t0 = time.perf_counter()
        for t in range(1, steps + 1):
            if mode != "off":
                trace.set_marks(mode == "marks" or
                                (mode == "alternate" and t % 2 == 0))
            served = greedy_to_host(prog.decode(c.feed(t, served)))[:, 0]
        wall = time.perf_counter() - t0
        rows, lost = trace.drain_spans()
    finally:
        trace.disable()
    return prog.batch * steps / wall, rows, lost


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(1)
    spec = cell.load_spec(ROOT, args.workload)
    conf, mix = spec.config, spec.traffic
    prog = cell.Program(conf, mix, weights.make(conf, args.seed, "cuda"),
                        "cuda")
    cell.warm_up(prog, mix, conf["vocab"], args.seed)
    # both traced graphs built before the first turn
    serve_turn(prog, mix, conf["vocab"], args.seed, 0, 4, "alternate")
    rates = {m: [] for m in MODES}
    resolve = {m: [] for m in MODES}
    period = {m: [] for m in MODES}
    wait = {m: [] for m in MODES}
    device = {m: [] for m in MODES}
    marked = []
    index = 1
    for rnd in range(args.rounds):
        order = MODES if rnd % 2 == 0 else MODES[::-1]
        for mode in order:
            rate, rows, lost = serve_turn(prog, mix, conf["vocab"], args.seed,
                                          index, args.steps, mode)
            index += 1
            rates[mode].append(rate)
            period[mode].append(1e3 * prog.batch / rate)
            resolve[mode].append(sum(r["dur_s"] for r in rows
                                     if r["name"] == "obs.resolve")
                                 * 1e3 / args.steps)
            reps = sorted((r for r in rows
                           if r["name"] == program_trace.DECODE_REPLAY),
                          key=lambda r: r["dev_t0"])
            plain = [r for r in reps if not r["marked"]]
            marked += [r for r in reps if r["marked"]]
            if len(reps) > 1:
                wait[mode].append(program_trace.host_wait_ms(reps, rows))
            if plain:
                device[mode].append(program_trace.device_ms(plain))
            print(f"round {rnd} {mode:>9}: {rate:.3f} tokens/s, obs.resolve "
                  f"{resolve[mode][-1]:.4f} ms a step, host wait "
                  f"{wait[mode][-1] if wait[mode] else None} ms, "
                  f"{lost} records lost", flush=True)

    def medians(by):
        return {m: statistics.median(v) if v else None for m, v in by.items()}

    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "tok_s": medians(rates), "period_ms": medians(period),
           "resolve_ms": medians(resolve),
           "host_wait_ms": medians(wait), "device_ms": medians(device),
           "marked_device_ms": program_trace.device_ms(marked)
           if marked else None}
    out["tok_s_vs_off"] = {m: out["tok_s"][m] / out["tok_s"]["off"] - 1
                           for m in MODES}
    phases = program_trace.phase_ms(marked)
    if phases is not None:
        calls = sum(1 for s in marked[0]["marks"] if s[2] == "quant")
        per_mark = ((out["marked_device_ms"] - out["device_ms"]["on"])
                    / (4 * calls + 2))
        out["sites_ms"] = phases
        out["site_ms"] = program_trace.site_ms(phases)
        out["site_epilogue_ms"] = program_trace.site_ms(phases, ("epilogue",))
        out["per_mark_us"] = 1e3 * per_mark
        out["site_ms_less_marks"] = out["site_ms"] - 3 * calls * per_mark
        out["site_epilogue_ms_less_marks"] = (out["site_epilogue_ms"]
                                              - calls * per_mark)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
