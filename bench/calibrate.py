"""The readings a cell's limits are set from: for each seed, one run of the
cell (a short window at the cell's own load) whose served tokens are held
against the reference, and the control's reading on the same prompts and
tokens (the reference with its products in float8). All seeds run in one
process.

    python3 bench/calibrate.py --workload nemotron4_15b.stream \
        --seeds 11,12,13 --seconds 8 --out chiprun_out/cal.jsonl

Prints one JSON line a seed (appended to `--out` too): each reading, and
`correct` for the program and `correct.<precision>` for the control and
the reordered reference, each the cell's limits applied as a run applies
them; at the end each reading's least and largest value over the seeds and
how many seeds each came out correct on. Needs a CUDA card, as `run.py`
does; the benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the control ("fp8"), and beside it the configuration's precision with its
# sums in another order (how far two sound computations drift apart)
PRECISIONS = ("fp8", "bf16_reordered")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from bench import cell

    spec = cell.load_spec(ROOT, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell.run(spec, seed, args.seconds, False, t_start=t0,
                     precisions=PRECISIONS)
        # the cell's limits applied to each precision's readings, as a run
        # applies them to the served tokens'
        verdicts = {f"correct.{p}": cell.compare(spec.limits,
                                                 r["readings"], p)[1]
                    for p in PRECISIONS}
        row = {"workload": args.workload, "seed": seed, **r["readings"],
               "cohorts": r["cohorts"], "correct": r["correct"], **verdicts,
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "run_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    summary = {"workload": args.workload}
    for key in rows[0]:
        if key.startswith("logit_gap"):
            vals = [r[key] for r in rows]
            summary[key] = {"min": min(vals), "max": max(vals)}
        elif key.startswith("correct"):
            summary[key] = sum(r[key] for r in rows)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
