"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `repro_torch` only, from the sources of this checkout, in phases;
every phase's failure is fatal (non-zero exit, no result line):

  1. device   — name, count, power limit; TF32 off for f32 matmuls and convs
  2. build    — compiles every kernel (one nvcc per source, in parallel) with
                `-Xptxas -v` and prints registers, shared memory and spills;
                checks that the int8 kernel's SASS holds both kinds of int8
                tensor-core instruction: IMMA (`mma.sync`, its 8-row tiles)
                and IGMMA (`wgmma`, its 128-row tiles); and that every bf16
                instance of the three float ΔW GEMMs (output-, input-
                stationary, ragged) holds a bf16 HMMA, and none a TF32 one
  3. kernels  — each Hopper kernel against its plain PyTorch version on the
                card: the reuse kernels at the full-width qwen3-32b and
                rwkv6-7b decode shapes (M = 8, block_m 8, block_k 256,
                block_n 128) and skip rates {0, 0.5, 0.78, 1.0}, plus an f32
                case at a small shape (each ΔW GEMM also bitwise equal from
                run to run, and prev_out passed through bitwise at skip
                1.0);
                wkv6_decode at rwkv6-7b decode (B 8, H 64, 64 x 64 state) with
                a nonzero bonus; reuse_matmul_int8 over a delta_encode_int8
                split at [8|128, 4096] x [4096, 14336] and the same skips, and
                at a shape whose split overflows (the int8 kernel runs on the
                int8 tensor cores); then each kernel's time (CUDA events over
                a CUDA-graph replay), its bound, the plain version's time and
                a one-call PyTorch yardstick where one exists (for int8 the
                faster of two weight layouts of `torch._int_mm`), the ΔW
                GEMMs with their weights rotated through more than the L2
                cache holds, and the output-stationary kernel at every k
                split it can launch
  4. serve    — `repro_torch.launch.serve.run` on full-width qwen3-32b cut to
                8 layers, reuse on (delta_quant, output- and input-stationary
                reuse_matmul must launch), every kernel call held against its
                plain version on that call's own inputs; then one decode step
                with impl="cuda" and with impl="torch" on the same card tensors
  5. ragged   — serve again with a tuned table pinning exec_path="ragged"
                (with a k-extent budget) on attn_qkv and mlp_in, checked the
                same way
  6. rwkv6    — serve full-width rwkv6-7b at full depth (32 layers) with
                reuse on: delta_quant, reuse_matmul_output and wkv6_decode must
                launch, every call held against its plain version on its own
                inputs; then one profiled decode step, and a cuda-vs-torch
                decode step as a diagnostic
  7. int8     — the int8 split entry point (delta_encode_int8, then
                ops.reuse_matmul_int8 on lo and on hi) at the rwkv6-7b channel
                mix shape, against the exact product

Before the last line it prints the kernels JSON line (launch counts from the
serve runs and the int8 path, errors and times from phase 3) and the card's
name and power limit; the last line is {"ok": true, "device": {...}}. Exits
non-zero when no CUDA device is available, and when the repository's package
is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import itertools
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
INT8_OPS = 1979e12            # H100 SXM dense int8 tensor cores
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
M, BM, BK, BN = 8, 8, 256, 128
SKIPS = (0.0, 0.5, 0.78, 1.0)
# (site, K, N, dataflow) of full-width qwen3-32b decode
SITES = (
    ("attn_qkv", 5120, 10240, "output"),
    ("attn_out", 8192, 5120, "output"),
    ("mlp_in", 5120, 51200, "output"),
    ("mlp_out", 25600, 5120, "input"),
)
# the same of full-width rwkv6-7b decode: every site is output-stationary
# (wr, wk, wv, wg, wo and cmix_wr are 4096 -> 4096)
RWKV_SITES = (
    ("rwkv_4096", 4096, 4096, "output"),
    ("cmix_wk", 4096, 14336, "output"),
    ("cmix_wv", 14336, 4096, "output"),
)
# a timed call reads its weight from HBM, as a decode step does: the timing
# loop rotates through enough copies of a smaller weight to exceed the 50 MB
# L2 cache three times over
ROTATE_BYTES = 150e6
N_LAYERS = 8
# rwkv6-7b decode: batch 8, 64 heads of 64
WKV_B, WKV_H, WKV_D = 8, 64, 64
# the int8 split at the rwkv6-7b channel mix (d 4096 -> d_ff 14336)
INT8_K, INT8_N = 4096, 14336
# bf16 GEMMs: products of bf16 values are exact in f32; only the f32
# summation order differs between the kernel and torch.matmul, an error that
# grows ~sqrt(K)·eps_f32 of the sum of |terms|.
GEMM_ATOL, GEMM_RTOL = 1e-3, 1e-4
F32_ATOL, F32_RTOL = 1e-4, 1e-5   # as tests/test_kernels.py for f32
# wkv6 readout: a 64-term f32 sum in another order. Its rounding error scales
# with the sum of |terms|, not with |out| (the terms cancel), so the rtol is
# taken of Σ_i |r_i·(u_i·kv_ij + S_ij)|.
WKV_ATOL, WKV_RTOL = 1e-5, 1e-5

# name: (CUDA source, the TPU kernel it replaces). All hand-written CUDA C++
# for sm_90a. reuse_matmul_int8 multiplies on the int8 tensor cores
# (`mma.sync ... s8` for 8-row tiles, `wgmma ... s8` for 128-row tiles); the
# three float ΔW GEMMs (output-, input-stationary, ragged: one cluster tile
# loop) on the bf16 tensor cores (`mma.sync ... bf16`, f32 accumulation) and
# their f32 operands on CUDA cores in IEEE f32; delta_quant and wkv6_decode
# on CUDA cores.
KERNEL_META = {
    "delta_quant": ("src/repro_torch/csrc/delta_quant.cu",
                    "src/repro/kernels/delta_quant.py:77"),
    "reuse_matmul_output": ("src/repro_torch/csrc/reuse_matmul.cu",
                            "src/repro/kernels/reuse_matmul.py:208"),
    "reuse_matmul_input": ("src/repro_torch/csrc/reuse_matmul.cu",
                           "src/repro/kernels/reuse_matmul.py:251"),
    "reuse_matmul_ragged": ("src/repro_torch/csrc/reuse_matmul_ragged.cu",
                            "src/repro/kernels/reuse_matmul_ragged.py:119"),
    "reuse_matmul_int8": ("src/repro_torch/csrc/reuse_matmul_int8.cu",
                          "src/repro/kernels/reuse_matmul_int8.py:80"),
    "wkv6_decode": ("src/repro_torch/csrc/wkv6_decode.cu",
                    "src/repro/kernels/wkv6_decode.py:71"),
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


def sass_functions(sass: str) -> dict[str, str]:
    """`cuobjdump -sass` text split by kernel: {mangled name: its SASS}."""
    parts = re.split(r"\n\s*Function : ", sass)[1:]
    return {p.split("\n", 1)[0].strip(): p for p in parts}


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


def wkv_terms(r, k, v, u, state):
    """Σ_i |r_i·(u_i·k_i·v_j + S_ij)|, [B, H, dv]: the scale of the readout's
    rounding error."""
    kv = k[..., :, None] * v[..., None, :]
    return (r[..., :, None] * (u[None, :, :, None] * kv + state)).abs().sum(-2)


def wkv_check(out, s_new, want_out, want_s, terms, what):
    """S' bitwise, out within WKV_ATOL + WKV_RTOL·Σ|terms|. Returns (max
    |err| of out, count of outputs outside atol + rtol·|ref|, a
    diagnostic)."""
    if not torch.equal(s_new, want_s):
        fail(f"{what}: wkv6_decode state differs from its plain version")
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: non-finite wkv6_decode output")
    err = (out - want_out).abs()
    if bool((err > WKV_ATOL + WKV_RTOL * terms).any()):
        fail(f"{what}: wkv6_decode out disagrees with its plain version: "
             f"max err {float(err.max()):.3e}")
    strict = int((err > WKV_ATOL + WKV_RTOL * want_out.abs()).sum())
    return float(err.max()), strict


class PathCheck:
    """Holds every kernel call of a serve run against its plain version on
    the exact inputs that call was given: each site of each layer at each
    decode step. While the run lasts, the wrappers of `repro_torch.kernels.
    ops` (which the engine calls through the module) are swapped for
    checking ones. A check runs right after its kernel, before the engine
    writes the call's outputs back into the cache, so the inputs it reuses
    (x, prev_q, Δ, mask, prev_out) are still the call's own. The plain
    versions launch no kernel, so the launch counts stay the path's."""

    NAMES = ("delta_quant_fused", "reuse_matmul", "reuse_matmul_ragged",
             "wkv6_decode")

    def __init__(self, ops):
        self.ops = ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.checked = {k: 0 for k in KERNEL_META}
        self.max_err = {k: 0.0 for k in KERNEL_META}
        self.wkv_strict = 0

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

    def wkv6_decode(self, r, k, v, w, u, state, *, impl):
        # the kernel updates `state` in place: the plain version runs on a
        # copy of the state the call was given
        want_s = state.clone()
        got = self.orig["wkv6_decode"](r, k, v, w, u, state, impl=impl)
        terms = wkv_terms(r.float(), k.float(), v.float(), u.float(), want_s)
        want = self.orig["wkv6_decode"](r, k, v, w, u, want_s, impl="torch")
        err, strict = wkv_check(got, state, want, want_s, terms,
                                "serve path")
        self.wkv_strict += strict
        self._note("wkv6_decode", err)
        return got


def clone_state(tree):
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    return tree.clone()


def int8_codes(m, k, skip, bm, bk, gen, dev, overflow=False):
    """(cur, prev, mask) int8 codes whose delta has exactly round(skip·gm·gk)
    zero (bm × bk) tiles: a changed tile moves each code by ±1..20 (clipped
    to the int8 range). With `overflow` a few codes of the first changed tile
    jump from -127 to 127, so hi is nonzero there."""
    mask = random_mask(m // bm, k // bk, skip, gen, dev)
    prev = torch.randint(-127, 128, (m, k), generator=gen, device=dev)
    step = torch.randint(1, 21, (m, k), generator=gen, device=dev)
    sign = torch.randint(0, 2, (m, k), generator=gen, device=dev) * 2 - 1
    cur = torch.clamp(prev + step * sign * expand(mask, bm, bk), -127, 127)
    if overflow:
        i, j = (int(x) for x in torch.nonzero(mask)[0])
        cur[i * bm:i * bm + 2, j * bk:j * bk + 3] = 127
        prev[i * bm:i * bm + 2, j * bk:j * bk + 3] = -127
    return cur.to(torch.int8), prev.to(torch.int8), mask


def int8_split(enc, wq, acc, bm, bn, bk, ops):
    """The int8 split entry point: lo, then hi onto lo's result."""
    lo = ops.reuse_matmul_int8(enc.lo, wq, acc, enc.lo_mask, block_m=bm,
                               block_n=bn, block_k=bk)
    return lo, ops.reuse_matmul_int8(enc.hi, wq, lo, enc.hi_mask, block_m=bm,
                                     block_n=bn, block_k=bk)


def exact_int8(cur, prev, wq, acc):
    """acc + (cur − prev) @ wq, exact in f64 (|terms| <= 254·127, sums far
    below 2^53)."""
    return (acc.double() + (cur.double() - prev.double())
            @ wq.double()).to(torch.int32)


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
    output at the first site of the step)."""
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
        first[impl] = rc[next(iter(eng.sites))]["prev_out"][0]
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
    del params, state
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
    from repro_torch.kernels.reuse_matmul import (
        CLUSTERS,
        SUB_K,
        k_split,
        reuse_matmul,
        reuse_matmul_torch,
    )
    from repro_torch.kernels.reuse_matmul_ragged import (
        reuse_matmul_ragged,
        reuse_matmul_ragged_torch,
    )
    from repro_torch.kernels.reuse_matmul_int8 import (
        reuse_matmul_int8,
        reuse_matmul_int8_torch,
    )
    from repro_torch.kernels.wkv6_decode import wkv6_decode, wkv6_decode_torch
    from repro_torch.launch import serve
    from repro_torch.core.delta import compact_rows, delta_encode_int8
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
    sass = backend.sass("reuse_matmul_int8")
    tc = {kind: sorted({m.group(0) for m in re.finditer(
        rf"\b{kind}\.\S+", sass)}) for kind in ("IMMA", "IGMMA")}
    for kind, found in tc.items():
        if not found:
            fail(f"no {kind} instruction in the SASS of reuse_matmul_int8")
    counts = {kind: len(re.findall(rf"\b{kind}\.", sass)) for kind in tc}
    print("reuse_matmul_int8 SASS, int8 tensor-core instructions: "
          + "; ".join(f"{counts[kind]} {kind} ({', '.join(found)})"
                      for kind, found in tc.items()))
    # every bf16 instance of the cluster tile loop multiplies on the bf16
    # tensor cores; f32 instances stay IEEE f32 (no HMMA, no TF32)
    for lib, lists in (("reuse_matmul", ("MaskList", "InputList")),
                       ("reuse_matmul_ragged", ("RaggedList",))):
        fns = sass_functions(backend.sass(lib))
        for lst in lists:
            for dt in ("bfloat16", "f"):
                found = [body for fn, body in fns.items()
                         if lst in fn and ("bfloat16" in fn) == (dt != "f")]
                if len(found) != 1:
                    fail(f"{lib}: {len(found)} {dt} {lst} kernels in the SASS")
                hmma = re.findall(r"\bHMMA\.\S+", found[0])
                if any("TF32" in h for h in hmma):
                    fail(f"{lib}: a TF32 HMMA in the {lst} kernel")
                if dt == "f" and hmma:
                    fail(f"{lib}: f32 {lst} kernel on the tensor cores")
                if dt != "f" and "HMMA.16816.F32.BF16" not in hmma:
                    fail(f"{lib}: no HMMA.16816.F32.BF16 in the bf16 {lst} "
                         "kernel")
                print(f"{lib} SASS, {dt} {lst} kernel: {len(hmma)} HMMA "
                      f"({', '.join(sorted(set(hmma))) or 'CUDA cores'})")
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

    # ΔW GEMMs, both dataflows, and ragged, at every site shape and skip:
    # each within its tolerance, bitwise equal from run to run (fixed deal,
    # rank-order reduction) and prev_out passed through bitwise at skip 1.0.
    # The rwkv6 shapes draw from a generator of their own, so the qwen3
    # phases see the same inputs whatever is added there.
    gen_w = torch.Generator(device=dev)
    gen_w.manual_seed(2)
    for (site, k, n, dataflow), g in [(s, gen) for s in SITES] + \
            [(s, gen_w) for s in RWKV_SITES]:
        for skip in SKIPS:
            delta, w, prev, mask = gemm_operands(M, k, n, skip, torch.bfloat16,
                                                 g, dev)
            ref = reuse_matmul_torch(delta, w, prev, mask, block_m=BM,
                                     block_k=BK)
            runs = {f"reuse_matmul_{dataflow}": lambda: reuse_matmul(
                delta, w, prev, mask, block_m=BM, block_n=BN, block_k=BK,
                dataflow=dataflow)}
            if dataflow == "output":
                idx, counts = compact_rows(mask)
                runs["reuse_matmul_ragged"] = lambda: reuse_matmul_ragged(
                    delta, w, prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK)
            for kname, run in runs.items():
                out = run()
                max_err[kname] = max(max_err[kname],
                                     close(out, ref, GEMM_ATOL, GEMM_RTOL))
                if not torch.equal(out, run()):
                    fail(f"{kname} differs from run to run at {site} skip "
                         f"{skip}")
                if skip == 1.0 and not torch.equal(out, prev):
                    fail(f"{kname} did not pass prev_out through at {site} "
                         "skip 1.0")
        print(f"{site}: [{M},{k}]x[{k},{n}] bf16 {dataflow}-stationary"
              + (" and ragged" if dataflow == "output" else "")
              + f" within atol {GEMM_ATOL} rtol {GEMM_RTOL} at all skips, "
              "bitwise from run to run, prev_out bitwise at skip 1.0")
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
          "included; ΔW GEMM weights rotated through "
          f"{ROTATE_BYTES / 1e6:.0f} MB):")
    lib_rm = backend.library("reuse_matmul")
    n_sm = backend.sm_count(0)
    by_shape = {"reuse_matmul_output": {}, "reuse_matmul_ragged": {}}
    for (site, k, n, dataflow), g in [(s, gen) for s in SITES] + \
            [(s, gen_w) for s in RWKV_SITES]:
        for skip in (0.0, 0.78):
            delta, w, prev, mask = gemm_operands(M, k, n, skip, torch.bfloat16,
                                                 g, dev)
            copies = math.ceil(ROTATE_BYTES / (w.numel() * w.element_size()))
            nxt = itertools.cycle([w] + [w.clone() for _ in range(copies - 1)])
            wn = nxt.__next__
            byts = gemm_bytes(delta, w, mask, BK)
            flops = 2 * M * n * int(mask.sum()) * BK
            bound = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            kname = f"reuse_matmul_{dataflow}"
            t_k = time_ms(lambda: reuse_matmul(
                delta, wn(), prev, mask, block_m=BM, block_n=BN, block_k=BK,
                dataflow=dataflow))
            t_p = time_ms(lambda: reuse_matmul_torch(
                delta, wn(), prev, mask, block_m=BM, block_k=BK), iters=5)
            t_l = time_ms(lambda: torch.addmm(prev, delta, wn(),
                                              out_dtype=torch.float32))
            t_e = time_ms(lambda: reuse_matmul(
                delta, wn(), prev, mask, block_m=BM, block_n=BN, block_k=BK,
                dataflow=dataflow), graph=False)
            line = (f"  {site:9s} skip={skip:.2f} {kname}: {t_k:.4f} "
                    f"(eager call {t_e:.4f}) bound {bound:.4f} plain "
                    f"{t_p:.4f} library {t_l:.4f}")
            entries = [(kname, t_k, t_p)]
            if dataflow == "output":
                idx, counts = compact_rows(mask)
                t_r = time_ms(lambda: reuse_matmul_ragged(
                    delta, wn(), prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK))
                t_rp = time_ms(lambda: reuse_matmul_ragged_torch(
                    delta, wn(), prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK), iters=5)
                line += f" | ragged {t_r:.4f} plain {t_rp:.4f}"
                entries.append(("reuse_matmul_ragged", t_r, t_rp))
                # the output-stationary kernel at each k split it can
                # launch, called directly; k_split's pick is marked
                pick = k_split(M, n, k, n_sm)
                if skip == 0.0:
                    out = torch.empty_like(prev)
                    code = backend.DTYPE_CODE[delta.dtype]
                    sweep = []
                    for c in (c for c in CLUSTERS if c <= k // SUB_K):
                        t_c = time_ms(lambda: backend.check(
                            lib_rm.rt_reuse_matmul_output(
                                delta.data_ptr(), wn().data_ptr(), code,
                                prev.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), M, k, n, BM, BK, c,
                                backend.stream_ptr(dev)), "k split sweep"))
                        sweep.append(f"C={c}{'*' if c == pick else ''} "
                                     f"{t_c:.4f}")
                    line += "\n      k split (* = k_split): " + ", ".join(sweep)
            print(line)
            for kn, t, tp in entries:
                if kn in by_shape:
                    by_shape[kn][f"{site} [{M},{k}]x[{k},{n}] skip {skip}"] = {
                        "ms": t, "bound_ms": bound, "library_ms": t_l}
            # the JSON line keeps each kernel's largest main-path shape at
            # skip 0: mlp_in (output, ragged) and mlp_out (input)
            if skip == 0.0 and site in ("mlp_in", "mlp_out"):
                for kn, t, tp in entries:
                    results[kn] = {
                        "shape": f"[{M},{k}]x[{k},{n}] bf16 skip {skip}",
                        "ms": t, "plain_ms": tp, "bound_ms": bound,
                        "bound_by": (
                            "bytes" if byts / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations"),
                        "library_ms": t_l,
                    }
            # the input-stationary row also carries the skip at work
            if skip == 0.78 and dataflow == "input":
                results[kname]["ms_skip_0.78"] = t_k
                results[kname]["bound_ms_skip_0.78"] = bound
            del nxt, wn
    for kn, shapes in by_shape.items():
        results[kn]["by_shape"] = shapes
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

    # wkv6_decode at rwkv6-7b decode with a nonzero bonus and a random
    # state (the serve path's bonus is zero): S' bitwise, out within
    # WKV_ATOL + WKV_RTOL·Σ|terms|. The third case puts w near 1, as the
    # model's decay exp(-exp(-6)) is. The rwkv6 kernels draw from a
    # generator of their own, so the qwen3 phases see the same inputs
    # whatever is added here.
    gen_r = torch.Generator(device=dev)
    gen_r.manual_seed(1)
    wshape = (WKV_B, WKV_H, WKV_D)
    strict = 0
    for case in range(3):
        r, k, v = (torch.randn(wshape, generator=gen_r, device=dev)
                   for _ in range(3))
        w = torch.rand(wshape, generator=gen_r, device=dev)
        w = 1.0 - w * 0.01 if case == 2 else w * 0.9 + 0.05
        u = torch.randn((WKV_H, WKV_D), generator=gen_r, device=dev)
        state = torch.randn((*wshape, WKV_D), generator=gen_r,
                            device=dev) * (1 + 10 * case)
        want_o, want_s = wkv6_decode_torch(r, k, v, w, u, state)
        terms = wkv_terms(r, k, v, u, state)
        out, _ = wkv6_decode(r, k, v, w, u, state)
        err, n_strict = wkv_check(out, state, want_o, want_s, terms,
                                  "wkv6_decode")
        strict += n_strict
        max_err["wkv6_decode"] = max(max_err["wkv6_decode"], err)
    print(f"wkv6_decode: [{WKV_B},{WKV_H},{WKV_D}] x {WKV_D}x{WKV_D} state, "
          f"nonzero bonus: S' bitwise, out within atol {WKV_ATOL} + rtol "
          f"{WKV_RTOL}·Σ|terms| (max err {max_err['wkv6_decode']:.3e}; "
          f"{strict} outputs outside atol + rtol·|out|, a diagnostic)")

    # int8 split: lo then hi through the kernel, bitwise against the plain
    # version and against the exact product
    wq = torch.randint(-127, 128, (INT8_K, INT8_N), generator=gen_r,
                       device=dev).to(torch.int8)
    for m8, bm8 in ((M, BM), (128, 128)):
        for skip, overflow in [(sk, False) for sk in SKIPS] + [(0.5, True)]:
            cur, prev, mask = int8_codes(m8, INT8_K, skip, bm8, BK, gen_r, dev,
                                         overflow)
            acc = torch.randint(-2 ** 20, 2 ** 20, (m8, INT8_N), generator=gen_r,
                                device=dev, dtype=torch.int32)
            enc = delta_encode_int8(cur, prev, block_m=bm8, block_k=BK)
            if not torch.equal(enc.lo_mask, mask) or \
                    bool(enc.has_overflow) != overflow:
                fail(f"delta_encode_int8 split of the m={m8} skip={skip} "
                     "codes is not the one constructed")
            lo = reuse_matmul_int8(enc.lo, wq, acc, enc.lo_mask, block_m=bm8,
                                   block_n=BN, block_k=BK)
            out = reuse_matmul_int8(enc.hi, wq, lo, enc.hi_mask, block_m=bm8,
                                    block_n=BN, block_k=BK)
            want_lo = reuse_matmul_int8_torch(enc.lo, wq, acc, enc.lo_mask,
                                              block_m=bm8, block_k=BK)
            want = reuse_matmul_int8_torch(enc.hi, wq, want_lo, enc.hi_mask,
                                           block_m=bm8, block_k=BK)
            if not (torch.equal(lo, want_lo) and torch.equal(out, want)):
                fail(f"reuse_matmul_int8 differs from its plain version at "
                     f"m={m8} skip={skip} overflow={overflow}")
            if not torch.equal(out, exact_int8(cur, prev, wq, acc)):
                fail(f"int8 split lo+hi is not the exact product at m={m8} "
                     f"skip={skip}")
        print(f"reuse_matmul_int8: [{m8},{INT8_K}]x[{INT8_K},{INT8_N}] "
              f"block_m {bm8}, lo then hi bitwise equal to the plain version "
              "and to the exact product at skip {0, 0.5, 0.78, 1.0} and with "
              "an overflowing split")

    print("\ntimes of the rwkv6 kernels (ms per call, as above):")
    r, k, v = (torch.randn(wshape, generator=gen_r, device=dev)
               for _ in range(3))
    w = torch.rand(wshape, generator=gen_r, device=dev) * 0.9 + 0.05
    u = torch.randn((WKV_H, WKV_D), generator=gen_r, device=dev)
    state = torch.randn((*wshape, WKV_D), generator=gen_r, device=dev)
    t_k = time_ms(lambda: wkv6_decode(r, k, v, w, u, state))
    t_p = time_ms(lambda: wkv6_decode_torch(r, k, v, w, u, state), iters=5)
    t_e = time_ms(lambda: wkv6_decode(r, k, v, w, u, state), graph=False)
    # the state read and written once, r/k/v/w read, u read, out written;
    # ~7 f32 operations per state element (kv, u·kv, +S, r·(..) as two, w·S,
    # +kv)
    byts = 4 * (2 * state.numel() + 5 * r.numel() + u.numel())
    flops = 7 * state.numel()
    bound = max(byts / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    print(f"  wkv6_decode [{WKV_B},{WKV_H},{WKV_D}]: {t_k:.4f} (eager call "
          f"{t_e:.4f}) bound {bound:.6f} plain {t_p:.4f}; library: none (no "
          "single PyTorch call computes the readout and the state update)")
    results["wkv6_decode"] = {
        "shape": f"[{WKV_B},{WKV_H},{WKV_D}] f32, {WKV_D}x{WKV_D} state",
        "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": (
            "bytes" if byts / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations"), "library_ms": None,
    }
    for m8, bm8 in ((M, BM), (128, 128)):
        for skip in (0.0, 0.78):
            cur, prev, mask = int8_codes(m8, INT8_K, skip, bm8, BK, gen_r, dev)
            enc = delta_encode_int8(cur, prev, block_m=bm8, block_k=BK)
            acc = torch.zeros((m8, INT8_N), dtype=torch.int32, device=dev)
            t_k = time_ms(lambda: reuse_matmul_int8(
                enc.lo, wq, acc, enc.lo_mask, block_m=bm8, block_n=BN,
                block_k=BK))
            t_p = time_ms(lambda: reuse_matmul_int8_torch(
                enc.lo, wq, acc, enc.lo_mask, block_m=bm8, block_k=BK),
                iters=5)
            t_e = time_ms(lambda: reuse_matmul_int8(
                enc.lo, wq, acc, enc.lo_mask, block_m=bm8, block_n=BN,
                block_k=BK), graph=False)
            # The yardstick, which the port never calls: `torch._int_mm` with
            # the weight as the kernel takes it (N-major) and K-major (the
            # layout cuBLASLt's int8 path takes natively); the faster one
            # is library_ms. `_int_mm` requires M > 16, so there is none at
            # M = 8.
            t_ln = t_lk = t_l = None
            if m8 > 16:
                wq_t = wq.t().contiguous()
                t_ln = time_ms(lambda: torch._int_mm(enc.lo, wq))
                t_lk = time_ms(lambda: torch._int_mm(enc.lo, wq_t.t()))
                t_l = min(t_ln, t_lk)
                del wq_t
            active_k = int((mask != 0).any(dim=0).sum())
            byts = (active_k * BK * INT8_N + m8 * INT8_K + 2 * 4 * m8 * INT8_N
                    + mask.numel() * 4)
            iops = 2 * bm8 * INT8_N * BK * int(mask.sum())
            bound = max(byts / HBM_BYTES_PER_S, iops / INT8_OPS) * 1e3
            print(f"  reuse_matmul_int8 [{m8},{INT8_K}]x[{INT8_K},{INT8_N}] "
                  f"skip={skip:.2f}: {t_k:.4f} (eager call {t_e:.4f}) bound "
                  f"{bound:.4f} plain {t_p:.4f} library "
                  + ("n/a (torch._int_mm requires M > 16)" if t_l is None
                     else f"{t_l:.4f} (_int_mm N-major weight {t_ln:.4f}, "
                          f"K-major {t_lk:.4f})"))
            if m8 == 128 and skip == 0.0:
                results["reuse_matmul_int8"] = {
                    "shape": f"[{m8},{INT8_K}]x[{INT8_K},{INT8_N}] int8 "
                             f"block_m {bm8} skip {skip}",
                    "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                    "bound_by": ("bytes" if byts / HBM_BYTES_PER_S
                                 >= iops / INT8_OPS else "operations"),
                    "library_ms": t_l,
                }
    del wq, enc, cur, prev, acc, state

    # -------------------------------------------------------------- 4. serve
    phase("4. serve, default path (qwen3-32b full width, 8 layers)")
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=N_LAYERS)
    serve_argv = ["--arch", "qwen3-32b", "--reuse", "--batch-slots", "8",
                  "--requests", "8", "--prompt-len", "32", "--cache-len",
                  "128", "--max-new", "8"]

    def drive(cfg, argv):
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
              f"{GEMM_ATOL} rtol {GEMM_RTOL}, wkv6 state bitwise and out "
              f"within atol {WKV_ATOL} + rtol {WKV_RTOL}·Σ|terms|; max err "
              + ", ".join(f"{kn} {chk.max_err[kn]:.3e}"
                          for kn, n in chk.checked.items() if n))
        if chk.checked["wkv6_decode"]:
            print(f"  wkv6 outputs outside atol + rtol·|out| (diagnostic): "
                  f"{chk.wkv_strict}")
        if len(res["done"]) != args.requests:
            fail("not every request finished")
        if text.count("SensorReport rid=") != args.requests or \
                "SensorReport model:" not in text:
            fail("SensorReport lines missing")
        print(f"launches: {counts}")
        return res, counts

    _, launches_default = drive(cfg, serve_argv)
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
        _, launches_ragged = drive(cfg, serve_argv + ["--tuned-policy",
                                                      table])
    if launches_ragged["reuse_matmul_ragged"] <= 0:
        fail("reuse_matmul_ragged was not launched on the ragged serve path")

    # ------------------------------------------------------------- 6. rwkv6
    # uncut: all 32 layers, 15.1 GB of bf16 weights
    rcfg = get_config("rwkv6-7b")
    phase(f"6. serve, rwkv6-7b (full width, {rcfg.n_layers} layers)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, launches_rwkv = drive(rcfg, [
        "--arch", "rwkv6-7b", "--reuse", "--batch-slots", "8", "--requests",
        "8", "--prompt-len", "32", "--cache-len", "128", "--max-new", "8"])
    print(f"rwkv6 serve phase: {time.perf_counter() - t0:.1f} s with the "
          f"checks; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for kn in ("delta_quant", "reuse_matmul_output", "wkv6_decode"):
        if launches_rwkv[kn] <= 0:
            fail(f"{kn} was not launched on the rwkv6 serve path")
    gc.collect()
    torch.cuda.empty_cache()
    # One decode step with impl="cuda" and impl="torch" from the same state:
    # a diagnostic of the code-flip cascade (see phase 4), no token check.
    # Checked: the step's first site (layer 0's rwkv_wr) sees identical codes
    # and its output is within the GEMM tolerance.
    err, scale_l, toks_equal, times, flips, first_err = decode_compare(
        rcfg, gen, dev)
    print(f"decode step bfloat16 cuda vs torch (diagnostic): max |dlogit| "
          f"{err:.3e} (max |logit| {scale_l:.3e}); greedy tokens equal: "
          f"{toks_equal}")
    for site, per_layer in flips.items():
        print(f"  {site:13s} codes differing, layers 0-3: "
              + " ".join(f"{f:.2e}" for f in per_layer[:4])
              + f" ... layer {len(per_layer) - 1}: {per_layer[-1]:.2e}")
    print(f"  layer 0 rwkv_wr output max |err| {first_err:.3e}")
    if flips["rwkv_wr"][0] != 0.0:
        fail("layer 0 rwkv_wr codes differ: its input passes no kernel")
    print(f"decode step bfloat16 time (host clock around synchronize): cuda "
          f"{times['cuda']:.2f} ms, torch {times['torch']:.2f} ms")
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 7. int8
    phase("7. int8 split entry point (rwkv6-7b channel mix shape)")
    wq = torch.randint(-127, 128, (INT8_K, INT8_N), generator=gen,
                       device=dev).to(torch.int8)
    cases = []
    for m8, bm8 in ((M, BM), (128, 128)):
        cur, prev, _ = int8_codes(m8, INT8_K, 0.5, bm8, BK, gen, dev,
                                  overflow=True)
        acc = torch.randint(-2 ** 20, 2 ** 20, (m8, INT8_N), generator=gen,
                            device=dev, dtype=torch.int32)
        cases.append((m8, bm8, cur, prev, acc))
    backend.reset_launches()
    outs = [int8_split(delta_encode_int8(cur, prev, block_m=bm8, block_k=BK),
                       wq, acc, bm8, BN, BK, ops)[1]
            for m8, bm8, cur, prev, acc in cases]
    torch.cuda.synchronize()
    launches_int8 = backend.launch_counts()
    for out, (m8, bm8, cur, prev, acc) in zip(outs, cases):
        if not torch.equal(out, exact_int8(cur, prev, wq, acc)):
            fail(f"int8 split path at m={m8} is not the exact product")
        print(f"int8 split [{m8},{INT8_K}]x[{INT8_K},{INT8_N}] block_m {bm8}:"
              " lo + hi equal to the exact product")
    print(f"launches: {launches_int8}")
    if launches_int8["reuse_matmul_int8"] <= 0:
        fail("reuse_matmul_int8 was not launched on the int8 split path")

    kernels = []
    path_launches = {"reuse_matmul_ragged": launches_ragged,
                     "wkv6_decode": launches_rwkv,
                     "reuse_matmul_int8": launches_int8}
    for kn, (src, replaces) in KERNEL_META.items():
        r = results[kn]
        launches = path_launches.get(kn, launches_default)[kn]
        kernels.append({"name": kn, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": max_err[kn], **r})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
