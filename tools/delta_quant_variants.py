"""Time variants of the delta_quant kernel side by side on one card.

    python3 tools/delta_quant_variants.py [--baseline OLDER_delta_quant.cu]

A diagnostic of the kernel's design, not part of any serve path. It builds
patched copies of `src/repro_torch/csrc/delta_quant.cu` (one `nvcc` each,
all started together, into `build/variants/`), holds each against
`delta_quant_torch` bitwise, and times them in turns: a CUDA-graph replay
of 20 calls, the median of 7 replays, three rounds in alternating order,
beside the launch floor (a one-element `add_` in the same kind of replay).
It times the TPU kernel's port, `rt_delta_quant`; a patch also changes the
source's fused instance (`rt_delta_quant_account`), which it does not
call. The variants:

    new         the source as it is
    no_cluster  tall tiles on one CTA each (no cluster row slices)
    div_as_mul  the IEEE division replaced by a multiply; timing only,
                its codes differ
    scale_ldg   `scale` read by every thread, with no barrier
    baseline    an older version of the source (--baseline), whose C entry
                takes no `vec` argument

Then the fused instance (`rt_delta_quant_account`, a reuse site call's
pass and bookkeeping) cut down part by part, timing only, beside it whole
(held bitwise against its plain version) and `rt_delta_quant`: where its
time over the TPU kernel's port goes.

    no_ticket   the tile pass and the per-tile match counts, no ticket and
                no epilogue
    no_epilogue the ticket drawn, the last CTA's epilogue left out

Prints the card's name and power limit, then one line per shape (bf16 x
and delta, ms per call). Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import site_account as sa  # noqa: E402
from repro_torch.kernels.delta_quant import (  # noqa: E402
    delta_quant,
    delta_quant_torch,
)

SHAPES = ((8, 4096, 8, 256), (8, 14336, 8, 256), (8, 25600, 8, 256),
          (8, 25600, 8, 64), (128, 4096, 128, 256), (128, 25600, 128, 256))
# variant: (text in the source, its replacement)
PATCHES = {
    "no_cluster": ("while (shift < 3 &&", "while (false && shift < 3 &&"),
    "div_as_mul": ("rintf(__fdiv_rn(xv[i][e], s))",
                   "rintf(__fmul_rn(xv[i][e], s))"),
    "scale_ldg": ("  if (lead) s_scale = __ldg(scale);\n  __syncthreads();\n"
                  "  const float s = s_scale;",
                  "  const float s = __ldg(scale);"),
}


# the fused instance's cuts: (text in the source, its replacement)
FUSED_CUTS = {
    "no_ticket": ("if (last_cta()) epilogue(L, g, f);", ";"),
    "no_epilogue": ("if (last_cta()) epilogue(L, g, f);", "last_cta();"),
}
# (M, K, N) of the fused calls timed: rwkv6's 4096 sites, qwen3's mlp_out
FUSED_SHAPES = ((8, 4096, 4096), (8, 25600, 5120))


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out = backend.BUILD_DIR.parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [backend._nvcc(), *backend.NVCC_FLAGS, "-I", str(backend.CSRC),
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def entry(lib: ctypes.CDLL, with_vec: bool):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.rt_delta_quant
    f.argtypes = [p, i, p, p, p, p, i, p, i, i, i, i] + [i] * with_vec + [p]
    f.restype = i
    return f


def graph_ms(fn, iters: int = 20, replays: int = 7) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an older delta_quant.cu to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("delta_quant_variants: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    src = (backend.CSRC / "delta_quant.cu").read_text()
    sources = {"new": src}
    for name, (old, new) in PATCHES.items():
        if old not in src:
            sys.exit(f"delta_quant_variants: {name}'s patch no longer applies")
        sources[name] = src.replace(old, new)
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    libs = build(sources)
    fns = {name: entry(lib, name != "baseline") for name, lib in libs.items()}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    one = torch.zeros(1, device=dev)
    for m, k, bm, bk in SHAPES:
        x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        prev_q = torch.randint(-127, 128, (m, k), generator=gen,
                               device=dev).to(torch.int8)
        scale = torch.tensor(0.05, device=dev)
        q = torch.empty_like(prev_q)
        delta = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
        mask = torch.empty((m // bm, k // bk), dtype=torch.int32, device=dev)

        def call(name):
            vec = [] if name == "baseline" else [1]
            rc = fns[name](x.data_ptr(), 1, prev_q.data_ptr(),
                           scale.data_ptr(), q.data_ptr(), delta.data_ptr(),
                           1, mask.data_ptr(), m, k, bm, bk, *vec,
                           torch.cuda.current_stream().cuda_stream)
            backend.check(rc, f"variant {name}")

        want = delta_quant_torch(x, prev_q, scale, block_m=bm, block_k=bk)
        for name in fns:
            mask.fill_(-1)
            call(name)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip((q, delta, mask),
                                                          want))
            if name != "div_as_mul" and not same:
                sys.exit(f"delta_quant_variants: {name} differs from the "
                         f"plain version at [{m},{k}] block {bm}x{bk}")
        times = {name: [] for name in fns}
        floor = []
        for rnd in range(3):
            floor.append(graph_ms(lambda: one.add_(1)))
            for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                times[name].append(graph_ms(lambda: call(name)))
        bound = (m * k * 6 + (m // bm) * (k // bk) * 4 + 4) / 3.35e12 * 1e3
        print(f"[{m},{k}] block {bm}x{bk}: floor "
              f"{statistics.median(floor):.5f} bound {bound:.6f} "
              + " ".join(f"{n} {statistics.median(t):.5f}"
                         for n, t in times.items()), flush=True)

    fused(src, one)


def fused(src: str, one: torch.Tensor) -> None:
    """The fused instance whole and cut down (FUSED_CUTS), at FUSED_SHAPES,
    in turns, through `site_account.delta_quant_account` with its library
    swapped for each build."""
    from repro_torch.core.reuse_cache import ReuseSiteSpec, init_site_cache

    sources = {"fused": src}
    for name, (old, new) in FUSED_CUTS.items():
        if old not in src:
            sys.exit(f"delta_quant_variants: {name}'s cut no longer applies")
        sources[name] = src.replace(old, new)
    libs = build(sources)
    for lib in libs.values():
        for fn, argtypes in backend.SIGNATURES["delta_quant"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    real = backend.library
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for m, k, n in FUSED_SHAPES:
        entry = init_site_cache(ReuseSiteSpec("s", k, n), m, device=dev)
        entry["prev_q"].copy_(torch.randint(-127, 128, (m, k), generator=gen,
                                            device=dev))
        x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        kw = dict(block_m=8, block_k=256, delta_dtype=torch.bfloat16,
                  path="kernel", dataflow="output", n=n, gn=n // 128,
                  w_itemsize=2, ema_decay=0.9, budget=None)

        def call(name, lanes):
            backend.library = lambda lib: libs[name] \
                if lib == "delta_quant" else real(lib)
            try:
                return sa.delta_quant_account(x, lanes, **kw)
            finally:
                backend.library = real

        got, want = sa.copy_lanes(entry), sa.copy_lanes(entry)
        out = call("fused", got)
        ref = sa.delta_quant_account_torch(x, want, **kw)
        torch.cuda.synchronize()
        if sa.differing_lanes(sa.written_lanes(got), sa.written_lanes(want)) \
                or not all(torch.equal(a, b) for a, b in zip(out, ref)):
            sys.exit(f"delta_quant_variants: the fused instance differs from "
                     f"its plain version at [{m},{k}]")
        prev_q = entry["prev_q"].clone()
        scale = entry["scale"]
        times = {name: [] for name in ["delta_quant", *libs]}
        floor = []
        lanes = sa.copy_lanes(entry)
        for rnd in range(3):
            floor.append(graph_ms(lambda: one.add_(1)))
            names = list(times) if rnd % 2 == 0 else list(times)[::-1]
            for name in names:
                if name == "delta_quant":
                    times[name].append(graph_ms(lambda: delta_quant(
                        x, prev_q, scale, block_m=8, block_k=256)))
                else:
                    times[name].append(graph_ms(lambda: call(name, lanes)))
        print(f"fused [{m},{k}] block 8x256: floor "
              f"{statistics.median(floor):.5f} "
              + " ".join(f"{nm} {statistics.median(t):.5f}"
                         for nm, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
