"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `repro_torch` only, from the sources of this checkout, in phases;
every phase's failure is fatal (non-zero exit, no result line):

  1. device   — name, count, power limit; TF32 off for f32 matmuls and convs
  2. build    — compiles every kernel (one nvcc per source, in parallel) with
                `-Xptxas -v` and prints registers, shared memory and spills
  3. kernels  — each Hopper kernel against its plain PyTorch version on the
                card, at the full-width qwen3-32b decode shapes (M = 8,
                block_m 8, block_k 256, block_n 128) and skip rates
                {0, 0.5, 0.78, 1.0}, plus an f32 case at a small shape; then
                its time (CUDA events), its bound, the plain version's time and
                a one-call PyTorch yardstick (`torch.addmm` of prev_out and
                Δ @ W with an f32 output)
  4. serve    — `repro_torch.launch.serve.run` on full-width qwen3-32b cut to
                8 layers, reuse on (delta_quant, output- and input-stationary
                reuse_matmul must launch), every kernel call held against its
                plain version on that call's own inputs; then one decode step
                with impl="cuda" and with impl="torch" on the same card tensors
  5. ragged   — serve again with a tuned table pinning exec_path="ragged"
                (with a k-extent budget) on attn_qkv and mlp_in, checked the
                same way

Before the last line it prints the kernels JSON line (launch counts from the
serve runs, errors and times from phase 3) and the card's name and power
limit; the last line is {"ok": true, "device": {...}}. Exits non-zero when no
CUDA device is available, and when the repository's package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor cores
M, BM, BK, BN = 8, 8, 256, 128
SKIPS = (0.0, 0.5, 0.78, 1.0)
# (site, K, N, dataflow) of full-width qwen3-32b decode
SITES = (
    ("attn_qkv", 5120, 10240, "output"),
    ("attn_out", 8192, 5120, "output"),
    ("mlp_in", 5120, 51200, "output"),
    ("mlp_out", 25600, 5120, "input"),
)
N_LAYERS = 8
# bf16 GEMMs: products of bf16 values are exact in f32; only the f32
# summation order differs between the kernel and torch.matmul, an error that
# grows ~sqrt(K)·eps_f32 of the sum of |terms|.
GEMM_ATOL, GEMM_RTOL = 1e-3, 1e-4
F32_ATOL, F32_RTOL = 1e-4, 1e-5   # as tests/test_kernels.py for f32

KERNEL_META = {
    "delta_quant": ("src/repro_torch/csrc/delta_quant.cu",
                    "src/repro/kernels/delta_quant.py:77"),
    "reuse_matmul_output": ("src/repro_torch/csrc/reuse_matmul.cu",
                            "src/repro/kernels/reuse_matmul.py:208"),
    "reuse_matmul_input": ("src/repro_torch/csrc/reuse_matmul.cu",
                           "src/repro/kernels/reuse_matmul.py:251"),
    "reuse_matmul_ragged": ("src/repro_torch/csrc/reuse_matmul_ragged.cu",
                            "src/repro/kernels/reuse_matmul_ragged.py:119"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = True) -> float:
    """Mean time of one call, from CUDA events after a warm-up. With `graph`
    the `iters` calls are captured once into a CUDA graph and the replay is
    timed: the device time of the work, without the host's per-call cost
    (which exceeds the kernel's own time for the small ones)."""
    side = torch.cuda.Stream()  # warm up off the capture's stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_mask(gm: int, gk: int, skip: float, gen, dev) -> torch.Tensor:
    """int32 [gm, gk] with exactly round(skip·gm·gk) zero tiles."""
    n = gm * gk
    mask = torch.ones(n, dtype=torch.int32, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    mask[perm[:round(skip * n)]] = 0
    return mask.view(gm, gk)


def expand(mask: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    return mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1)


def gemm_operands(m, k, n, skip, dtype, gen, dev, bm=BM, bk=BK):
    mask = random_mask(m // bm, k // bk, skip, gen, dev)
    delta = torch.randn((m, k), generator=gen, device=dev)
    delta = (delta * expand(mask, bm, bk)).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(dtype)
    prev = torch.randn((m, n), generator=gen, device=dev)
    return delta, w, prev, mask


def gemm_bytes(delta, w, mask, bk):
    """Bytes the ΔW GEMM must move: the active weight tiles (a weight row
    block is needed once if ANY m-row-block uses it), Δ, prev_out, out."""
    k, n = w.shape
    m = delta.shape[0]
    active_k = int((mask != 0).any(dim=0).sum())
    return (active_k * bk * n * w.element_size() + delta.numel()
            * delta.element_size() + 2 * m * n * 4 + mask.numel() * 4)


def close(out, ref, atol, rtol, what: str = "kernel") -> float:
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()):
        fail(f"non-finite output of {what}")
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        fail(f"{what} disagrees with its plain version: max err "
             f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


class PathCheck:
    """Holds every kernel call of a serve run against its plain version on
    the exact inputs that call was given: each site of each layer at each
    decode step. While the run lasts, the wrappers of `repro_torch.kernels.
    ops` (which the engine calls through the module) are swapped for
    checking ones. A check runs right after its kernel, before the engine
    writes the call's outputs back into the cache, so the inputs it reuses
    (x, prev_q, Δ, mask, prev_out) are still the call's own. The plain
    versions launch no kernel, so the launch counts stay the path's."""

    NAMES = ("delta_quant_fused", "reuse_matmul", "reuse_matmul_ragged")

    def __init__(self, ops):
        self.ops = ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.checked = {k: 0 for k in KERNEL_META}
        self.max_err = {k: 0.0 for k in KERNEL_META}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.ops, n, getattr(self, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ops, n, fn)

    def _note(self, kname: str, err: float) -> None:
        self.checked[kname] += 1
        self.max_err[kname] = max(self.max_err[kname], err)

    def delta_quant_fused(self, *args, impl, **kw):
        got = self.orig["delta_quant_fused"](*args, impl=impl, **kw)
        want = self.orig["delta_quant_fused"](*args, impl="torch", **kw)
        for a, b, what in zip(got, want, ("q", "delta", "mask")):
            if not torch.equal(a, b):
                fail(f"serve path: delta_quant {what} differs from its plain "
                     "version")
        self._note("delta_quant", 0.0)
        return got

    def reuse_matmul(self, *args, impl, dataflow, **kw):
        got = self.orig["reuse_matmul"](*args, impl=impl, dataflow=dataflow,
                                        **kw)
        want = self.orig["reuse_matmul"](*args, impl="torch",
                                         dataflow=dataflow, **kw)
        kname = f"reuse_matmul_{dataflow}"
        self._note(kname, close(got, want, GEMM_ATOL, GEMM_RTOL,
                                f"serve path: {kname}"))
        return got

    def reuse_matmul_ragged(self, *args, impl, **kw):
        got = self.orig["reuse_matmul_ragged"](*args, impl=impl, **kw)
        want = self.orig["reuse_matmul_ragged"](*args, impl="torch", **kw)
        self._note("reuse_matmul_ragged", close(
            got, want, GEMM_ATOL, GEMM_RTOL, "serve path: reuse_matmul_ragged"))
        return got


def clone_state(state):
    return {"len": state["len"].clone(),
            "blocks": {k: v.clone() for k, v in state["blocks"].items()}}


def profile_step(fn) -> None:
    """Where one decode step's time goes: device time by kernel name
    (torch.profiler, CUPTI) against the host wall time of the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: CPU-op rows carry their children's device time too
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3
    print(f"  profile of one bf16 decode step: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms ({busy / wall:.1%}), idle share "
          f"{max(0.0, 1 - busy / wall):.1%}")
    for e in rows[:12]:
        print(f"    {e.device_time_total / 1e3:8.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def decode_compare(cfg, gen, dev):
    """Prefill 8 random prompts, then run ONE decode step from a cold reuse
    cache with impl="cuda" and with impl="torch" on the same card tensors.
    Returns (max |dlogit|, max |logit|, greedy tokens equal, {impl: ms},
    {site: [share of differing codes per layer]}, max error of layer 0's
    attn_qkv output)."""
    from repro_torch.models import init_params
    from repro_torch.serve.serve_step import (
        build_reuse_engine, decode_step, greedy_sample, init_serve_state,
        prefill_step,
    )
    params = init_params(cfg, 1, device=dev)
    state = init_serve_state(cfg, 8, 128, device=dev)
    prompt = torch.randint(0, cfg.vocab, (8, 32), generator=gen, device=dev)
    with torch.no_grad():
        logits0, state = prefill_step(params, cfg, prompt, state)
    tok = greedy_sample(logits0)
    logits, times, codes, first = {}, {}, {}, {}
    for impl in ("cuda", "torch"):
        eng = build_reuse_engine(cfg, impl=impl)
        for rep in range(2):  # the second, timed step starts from the same state
            st = clone_state(state)
            rc = eng.init_cache(8, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, _, _ = decode_step(params, cfg, tok, st, engine=eng,
                                       reuse_cache=rc)
            torch.cuda.synchronize()
            times[impl] = (time.perf_counter() - t0) * 1e3
        logits[impl] = lg
        if impl == "cuda" and cfg.param_dtype == "bfloat16":
            profile_step(lambda: decode_step(
                params, cfg, tok, clone_state(state), engine=eng,
                reuse_cache=eng.init_cache(8, device=dev)))
        codes[impl] = {name: e["prev_q"] for name, e in rc.items()}
        first[impl] = rc["attn_qkv"]["prev_out"][0]
    if not bool(torch.isfinite(logits["cuda"]).all()):
        fail("non-finite logits from the cuda decode step")
    err = float((logits["cuda"] - logits["torch"]).abs().max())
    scale_l = float(logits["torch"].abs().max())
    toks_equal = torch.equal(greedy_sample(logits["cuda"]),
                             greedy_sample(logits["torch"]))
    # share of int8 activation codes that differ between the two runs, per
    # site and layer: where an f32 sum lands on the other side of a rounding
    # boundary the code flips, and the flip feeds the next site
    flips = {name: (codes["cuda"][name] != codes["torch"][name]).float()
             .mean(dim=(1, 2)).tolist() for name in codes["cuda"]}
    # the first reuse GEMM of the step sees identical inputs in both runs
    first_err = close(first["cuda"], first["torch"], GEMM_ATOL, GEMM_RTOL)
    return err, scale_l, toks_equal, times, flips, first_err


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(root / "src"))

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ops
    from repro_torch.kernels.delta_quant import delta_quant, delta_quant_torch
    from repro_torch.kernels.reuse_matmul import reuse_matmul, reuse_matmul_torch
    from repro_torch.kernels.reuse_matmul_ragged import (
        reuse_matmul_ragged,
        reuse_matmul_ragged_torch,
    )
    from repro_torch.launch import serve
    from repro_torch.core.delta import compact_rows
    from repro_torch.quant import quantize_int8

    # ------------------------------------------------------------- 1. device
    phase("1. device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name} (count {count}); capability "
          f"{torch.cuda.get_device_capability(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -------------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    logs = backend.build(verbose=True)
    print(f"built {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s into {backend.BUILD_DIR}")
    for src, log in logs.items():
        for line in log.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                print(f"  {src}: {line.strip()}")
    if backend.best() != "cuda":
        fail(f"substrate resolved to {backend.best()!r}, not cuda")
    print(f"kernel substrate: {backend.describe()}")

    # ------------------------------------------------------------ 3. kernels
    phase("3. kernels against their plain versions")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results: dict[str, dict] = {}
    max_err = {k: 0.0 for k in KERNEL_META}

    # delta_quant: bitwise on q, mask and delta
    for k in sorted({s[1] for s in SITES}):
        for skip in SKIPS:
            for scale_v, ties in ((0.05, False), (0.0625, True)):
                x = torch.randn((M, k), generator=gen, device=dev) * 2.0
                if ties:  # exact half-way codes exercise round-half-to-even
                    half = (torch.randint(-100, 100, (M, k), generator=gen,
                                          device=dev) + 0.5) * scale_v
                    pick = torch.rand((M, k), generator=gen, device=dev) < 0.25
                    x = torch.where(pick, half, x)
                x = x.to(torch.bfloat16)
                scale = torch.tensor(scale_v, dtype=torch.float32, device=dev)
                mask = random_mask(1, k // BK, skip, gen, dev)
                same = expand(mask, M, BK) == 0
                rand_q = torch.randint(-127, 128, (M, k), generator=gen,
                                       device=dev).to(torch.int8)
                prev_q = torch.where(same, quantize_int8(x, scale), rand_q)
                got = delta_quant(x, prev_q, scale, block_m=BM, block_k=BK,
                                  delta_dtype=torch.bfloat16)
                want = delta_quant_torch(x, prev_q, scale, block_m=BM,
                                         block_k=BK,
                                         delta_dtype=torch.bfloat16)
                for a, b, what in zip(got, want, ("q", "delta", "mask")):
                    if not torch.equal(a, b):
                        fail(f"delta_quant {what} differs at K={k} skip={skip}")
    xq = torch.randn((16, 512), generator=gen, device=dev)
    pq = torch.randint(-127, 128, (16, 512), generator=gen,
                       device=dev).to(torch.int8)
    sc = torch.tensor(0.05, device=dev)
    for a, b in zip(delta_quant(xq, pq, sc, block_m=8, block_k=128,
                                delta_dtype=torch.float32),
                    delta_quant_torch(xq, pq, sc, block_m=8, block_k=128,
                                      delta_dtype=torch.float32)):
        if not torch.equal(a, b):
            fail("delta_quant f32 case differs")
    print("delta_quant: q, delta and mask bitwise equal at K in "
          "{5120, 8192, 25600} x skip {0, 0.5, 0.78, 1.0} (+ ties, + f32)")

    # ΔW GEMMs, both dataflows, and ragged, at every site shape and skip
    for site, k, n, dataflow in SITES:
        for skip in SKIPS:
            delta, w, prev, mask = gemm_operands(M, k, n, skip, torch.bfloat16,
                                                 gen, dev)
            ref = reuse_matmul_torch(delta, w, prev, mask, block_m=BM,
                                     block_k=BK)
            out = reuse_matmul(delta, w, prev, mask, block_m=BM, block_n=BN,
                               block_k=BK, dataflow=dataflow)
            kname = f"reuse_matmul_{dataflow}"
            max_err[kname] = max(max_err[kname],
                                 close(out, ref, GEMM_ATOL, GEMM_RTOL))
            if dataflow == "output":
                idx, counts = compact_rows(mask)
                out = reuse_matmul_ragged(delta, w, prev, counts, idx,
                                          block_m=BM, block_n=BN, block_k=BK)
                max_err["reuse_matmul_ragged"] = max(
                    max_err["reuse_matmul_ragged"],
                    close(out, ref, GEMM_ATOL, GEMM_RTOL))
        print(f"{site}: [{M},{k}]x[{k},{n}] bf16 {dataflow}-stationary"
              + (" and ragged" if dataflow == "output" else "")
              + f" within atol {GEMM_ATOL} rtol {GEMM_RTOL} at all skips")
    # ragged: live counts above a budget (the reference's overflow regime,
    # which the budget-free walk needs no fallback for) and a count-0 row
    delta, w, prev, mask = gemm_operands(16, 5120, 10240, 0.5, torch.bfloat16,
                                         gen, dev)
    mask[1] = 0
    delta = delta * (expand(mask, BM, BK) != 0)
    ref = reuse_matmul_torch(delta, w, prev, mask, block_m=BM, block_k=BK)
    out = ops.reuse_matmul_ragged(delta, w, prev, mask, block_m=BM,
                                  block_n=BN, block_k=BK)
    max_err["reuse_matmul_ragged"] = max(max_err["reuse_matmul_ragged"],
                                         close(out, ref, GEMM_ATOL, GEMM_RTOL))
    _, counts = compact_rows(mask)
    gk = 5120 // BK
    if int(ops.budget_overflow(counts, gk=gk, max_active_k=1)) != 1 or \
            float(ops.ragged_grid_steps(counts, gm=2, gn=10240 // BN, gk=gk,
                                        max_active_k=1)) != 2 * 80 * gk:
        fail("ragged accounting missed the overflow of max_active_k=1")
    if not torch.equal(out[8:], prev[8:]):
        fail("ragged row with count 0 did not pass prev_out through")
    print("ragged: counts over a budget of 1 exact (accounted as the "
          "reference's full-extent fallback), count-0 row passes prev_out "
          "through")
    # f32 at a small shape, every kernel
    for dataflow in ("output", "input"):
        delta, w, prev, mask = gemm_operands(16, 512, 256, 0.5, torch.float32,
                                             gen, dev, bk=128)
        ref = reuse_matmul_torch(delta, w, prev, mask, block_m=8, block_k=128)
        out = reuse_matmul(delta, w, prev, mask, block_m=8, block_n=128,
                           block_k=128, dataflow=dataflow)
        close(out, ref, F32_ATOL, F32_RTOL)
        if dataflow == "output":
            idx, counts = compact_rows(mask)
            close(reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=8,
                                      block_n=128, block_k=128),
                  ref, F32_ATOL, F32_RTOL)
    print(f"f32 [16,512]x[512,256]: all GEMM kernels within atol {F32_ATOL} "
          f"rtol {F32_RTOL}")

    # times at the main path's shapes (skip 0 is what random-prompt serving
    # measures; 0.78 shows the skip at work)
    print("\ntimes (ms per call; CUDA events over a CUDA-graph replay of 20 "
          "calls after 3 warm-up; 'eager call' = 20 Python calls, host "
          "included):")
    for site, k, n, dataflow in SITES:
        for skip in (0.0, 0.78):
            delta, w, prev, mask = gemm_operands(M, k, n, skip, torch.bfloat16,
                                                 gen, dev)
            byts = gemm_bytes(delta, w, mask, BK)
            flops = 2 * M * n * int(mask.sum()) * BK
            bound = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            kname = f"reuse_matmul_{dataflow}"
            t_k = time_ms(lambda: reuse_matmul(
                delta, w, prev, mask, block_m=BM, block_n=BN, block_k=BK,
                dataflow=dataflow))
            t_p = time_ms(lambda: reuse_matmul_torch(
                delta, w, prev, mask, block_m=BM, block_k=BK), iters=5)
            t_l = time_ms(lambda: torch.addmm(prev, delta, w,
                                              out_dtype=torch.float32))
            t_e = time_ms(lambda: reuse_matmul(
                delta, w, prev, mask, block_m=BM, block_n=BN, block_k=BK,
                dataflow=dataflow), graph=False)
            line = (f"  {site:9s} skip={skip:.2f} {kname}: {t_k:.4f} "
                    f"(eager call {t_e:.4f}) bound {bound:.4f} plain "
                    f"{t_p:.4f} library {t_l:.4f}")
            entries = [(kname, t_k)]
            if dataflow == "output":
                idx, counts = compact_rows(mask)
                t_r = time_ms(lambda: reuse_matmul_ragged(
                    delta, w, prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK))
                t_rp = time_ms(lambda: reuse_matmul_ragged_torch(
                    delta, w, prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK), iters=5)
                line += f" | ragged {t_r:.4f} plain {t_rp:.4f}"
                entries.append(("reuse_matmul_ragged", t_r))
            print(line)
            # the JSON line keeps each kernel's largest main-path shape at
            # skip 0: mlp_in (output, ragged) and mlp_out (input)
            if skip == 0.0 and site in ("mlp_in", "mlp_out"):
                for kn, t in entries:
                    results[kn] = {
                        "shape": f"[{M},{k}]x[{k},{n}] bf16 skip {skip}",
                        "ms": t, "plain_ms": t_p if kn != "reuse_matmul_ragged"
                        else t_rp, "bound_ms": bound, "bound_by": (
                            "bytes" if byts / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations"),
                        "library_ms": t_l,
                    }
    for k in (5120, 8192, 25600):
        x = torch.randn((M, k), generator=gen, device=dev).to(torch.bfloat16)
        prev_q = torch.randint(-127, 128, (M, k), generator=gen,
                               device=dev).to(torch.int8)
        scale = torch.tensor(0.05, dtype=torch.float32, device=dev)
        t_k = time_ms(lambda: delta_quant(x, prev_q, scale, block_m=BM,
                                          block_k=BK))
        t_p = time_ms(lambda: delta_quant_torch(x, prev_q, scale, block_m=BM,
                                                block_k=BK))
        t_e = time_ms(lambda: delta_quant(x, prev_q, scale, block_m=BM,
                                          block_k=BK), graph=False)
        byts = M * k * (2 + 1 + 1 + 2) + (k // BK) * 4 + 4
        bound = byts / HBM_BYTES_PER_S * 1e3
        print(f"  delta_quant K={k}: {t_k:.4f} (eager call {t_e:.4f}) "
              f"bound {bound:.6f} plain {t_p:.4f}")
        if k == 25600:
            results["delta_quant"] = {
                "shape": f"[{M},{k}] bf16", "ms": t_k, "plain_ms": t_p,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            }

    # -------------------------------------------------------------- 4. serve
    phase("4. serve, default path (qwen3-32b full width, 8 layers)")
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=N_LAYERS)
    serve_argv = ["--arch", "qwen3-32b", "--reuse", "--batch-slots", "8",
                  "--requests", "8", "--prompt-len", "32", "--cache-len",
                  "128", "--max-new", "8"]

    def drive(argv):
        args = serve.build_parser().parse_args(argv)
        buf = io.StringIO()
        backend.reset_launches()
        with PathCheck(ops) as chk, contextlib.redirect_stdout(buf):
            res = serve.run(cfg, args)
        torch.cuda.synchronize()
        counts = backend.launch_counts()
        text = buf.getvalue()
        print(text, end="")
        if chk.checked != counts:
            fail(f"kernel calls checked {chk.checked} != launches {counts}")
        for kn, n in chk.checked.items():
            if n:
                max_err[kn] = max(max_err[kn], chk.max_err[kn])
        print("serve path: every kernel call (each site, layer and decode "
              "step) held against its plain version on the call's own "
              "inputs — delta_quant q/delta/mask bitwise, GEMMs within atol "
              f"{GEMM_ATOL} rtol {GEMM_RTOL}; max err "
              + ", ".join(f"{kn} {chk.max_err[kn]:.3e}"
                          for kn, n in chk.checked.items() if n))
        if len(res["done"]) != args.requests:
            fail("not every request finished")
        if text.count("SensorReport rid=") != args.requests or \
                "SensorReport model:" not in text:
            fail("SensorReport lines missing")
        print(f"launches: {counts}")
        return res, counts

    _, launches_default = drive(serve_argv)
    for kn in ("delta_quant", "reuse_matmul_output", "reuse_matmul_input"):
        if launches_default[kn] <= 0:
            fail(f"{kn} was not launched on the serve path")

    # One decode step, impl="cuda" vs impl="torch", on the same card tensors.
    # Every kernel call of the serve path was held against its plain version
    # on its own inputs above; here the two impls run whole steps apart. The
    # kernels sum in another order than torch.matmul, so a site output can
    # land on the other side of an int8 rounding boundary (scale 0.05) at the
    # next site and flip one code; one flipped input code shifts EVERY output
    # of that site by 0.05·W[k,:], so flips multiply site by site through the
    # random-weight stack. Checked: layer 0's attn_qkv passes no kernel before
    # it (identical codes) and its f32 output is within the GEMM tolerance;
    # at most 0.1% of layer 0's attn_out codes flip; greedy tokens are equal.
    # The logit gap is printed as a diagnostic of the cascade only.
    for dtype_name in ("bfloat16", "float32"):
        dcfg = dataclasses.replace(cfg, param_dtype=dtype_name)
        err, scale_l, toks_equal, times, flips, first_err = decode_compare(
            dcfg, gen, dev)
        print(f"decode step {dtype_name} cuda vs torch: max |dlogit| "
              f"{err:.3e} (max |logit| {scale_l:.3e}; diagnostic); greedy "
              f"tokens equal: {toks_equal}")
        for site, per_layer in flips.items():
            print(f"  {site:9s} codes differing per layer: "
                  + " ".join(f"{f:.2e}" for f in per_layer))
        print(f"  layer 0 attn_qkv output max |err| {first_err:.3e}")
        if flips["attn_qkv"][0] != 0.0:
            fail("layer 0 attn_qkv codes differ: its input passes no kernel")
        if flips["attn_out"][0] > 1e-3:
            fail("more than 0.1% of layer 0 attn_out codes differ")
        print(f"decode step {dtype_name} time (host clock around "
              f"synchronize): cuda {times['cuda']:.2f} ms, "
              f"torch {times['torch']:.2f} ms")
        if not toks_equal:
            fail(f"{dtype_name} greedy tokens differ between impl='cuda' and "
                 "impl='torch'")
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- 5. ragged
    phase("5. serve, ragged path (tuned table pins attn_qkv and mlp_in)")
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "ragged_table.json")
        with open(table, "w") as f:
            json.dump({
                "schema_version": 1, "kind": "reuse_tuned_table",
                "meta": {"written_by": "chip_smoke.py"},
                "sites": {s: {"exec_path": "ragged", "max_active_k": 10}
                          for s in ("attn_qkv", "mlp_in")},
            }, f)
        _, launches_ragged = drive(serve_argv + ["--tuned-policy", table])
    if launches_ragged["reuse_matmul_ragged"] <= 0:
        fail("reuse_matmul_ragged was not launched on the ragged serve path")

    kernels = []
    for kn, (src, replaces) in KERNEL_META.items():
        r = results[kn]
        launches = (launches_ragged if kn == "reuse_matmul_ragged"
                    else launches_default)[kn]
        kernels.append({"name": kn, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": max_err[kn], **r})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
