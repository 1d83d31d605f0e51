"""Run one cell of the benchmark on this machine's card and print its
result as the last line of standard output.

    python3 bench/run.py --workload nemotron4_15b.stream --seed 7 \
        --seconds 30 --trace 0

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (and the device's busy and traced seconds). Every run
checks the served tokens against the plain reference and prints each number
compared beside its limit, on standard error and under "check" in the
result. Without a CUDA card it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args()

    # the checkout's root and the program's sources; not this directory,
    # whose modules would shadow others by their bare names
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    # a kernel cache at a fixed path inside the checkout, should the program
    # ever compile through Triton (its own CUDA builds go to build/kernels/)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # one host thread for the CPU's own work: idle worker threads that spin
    # take cores from the thread that launches the graphs
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    torch.set_num_threads(1)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < chips[args.workload]):
        print("no CUDA card, or fewer cards than the cell asks for",
              file=sys.stderr)
        return 2

    from bench import cell

    spec = cell.load_spec(ROOT, args.workload)
    res = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    line = cell.result_line(res, bool(args.trace),
                            kind=torch.cuda.get_device_name(0),
                            count=chips[args.workload])
    cell.log(f"window {res['window_s']:.3f} s, {res['cohorts']} cohorts "
             f"finished, {res['served_checked']} served tokens checked")
    for name, c in res["check"].items():
        cell.log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
