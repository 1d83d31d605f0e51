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
                stationary, ragged) holds a bf16 HMMA, and none a TF32 one;
                that every 8-wide delta_quant instance loads x in 16-byte
                LDGs (printed: each instance's loads and stores by width,
                and the loads issued before its first barrier)
  3. kernels  — each Hopper kernel against its plain PyTorch version on the
                card: the reuse kernels at the full-width qwen3-32b and
                rwkv6-7b decode shapes (M = 8, block_m 8, block_k 256,
                block_n 128) and skip rates {0, 0.5, 0.78, 1.0}, plus an f32
                case at a small shape (each ΔW GEMM also bitwise equal from
                run to run, and prev_out passed through bitwise at skip
                1.0);
                delta_quant bitwise at every qwen3 and rwkv6 width (K 4096,
                5120, 8192, 14336, 25600), at blocks 128x256, 8x64 and 8x128,
                x/delta bf16/bf16, bf16/f32, f32/f32, and on views at an
                unaligned storage offset (its scalar instance), timed at
                every width beside the launch floor (a one-element add_);
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
                reuse_matmul must launch), twice: with `--eager`, every kernel
                call held against its plain version on that call's own inputs;
                then through the CUDA graphs of the compiled step on the same
                seed and traffic, whose tokens, SensorReport lines, launch
                counts and final reuse cache and decode state must equal the
                eager serve's (bitwise); then the decode step eagerly and as a
                graph replay in turns (median host times), one profiled eager
                step and one profiled replay (device busy and idle share), and
                one decode step with impl="cuda" and with impl="torch" on the
                same card tensors
  5. ragged   — the same pair with a tuned table pinning exec_path="ragged"
                (with a k-extent budget) on attn_qkv and mlp_in
  5b. refresh — the same pair with `--refresh-every 2` and a forced mode flip
                and flip back between steps: the graph serve must capture a
                new variant after a flip, and replay a known one after a flip
                back unless the policy refresh itself moved the key
  6. rwkv6    — the same pair on full-width rwkv6-7b at full depth (32
                layers): delta_quant, reuse_matmul_output and wkv6_decode must
                launch; then a cuda-vs-torch decode step as a diagnostic
  7. int8     — the int8 split entry point (delta_encode_int8, then
                ops.reuse_matmul_int8 on lo and on hi) at the rwkv6-7b channel
                mix shape, against the exact product
  8. measured — the measured-decode and trace-tuning loop on correlated
                traffic: (a) a skip sweep at every serve site shape (M = 8,
                skips 0-0.9: the site's masked kernel, ragged at
                ReusePolicy.ragged_budget, torch.addmm; each kernel held
                against its plain version) and two crossings a shape from
                tune.harvest.derive_break_even_skip; (b) record:
                sensor.runner.run_measured_decode on qwen3-32b (8 layers;
                batch 8 and 2) and rwkv6-7b (32 layers; batch 8) at
                correlation 0.95, eagerly with every kernel call checked,
                then twice through the CUDA graphs (timed; profiled), all
                three equal bitwise (summary lines, JSONL rows, launch
                counts, final cache and state); per-site skips, replay
                times, the ΔW GEMMs' device ms beside sensor_speedup; layer
                0 attn_qkv must skip; (c) fit: the record's JSONL through
                tune.load_trace and fit_trace(FitConfig(pallas_target=True,
                ragged_min_skip=<the measured break-even>)), save_table,
                load_tuned_policy; (d) exploit: the same stream on the tuned
                policy, checked as in (b); a site promoted to ragged must
                launch reuse_matmul_ragged
  9. control  — the online control plane (repro_torch.control): (a) the
                reference's acceptance scenario for it on qwen3-32b (8
                layers) and rwkv6-7b (32 layers): run_measured_decode at
                batch 2, correlation 1.0, 26 steps with a random-token
                burst at steps 19-22, a Controller every 2 steps from the
                default policy; eagerly with every kernel call checked,
                then through the graphs (timed), then again with a
                converged and a burst replay profiled; tokens, journal
                rows, specs, policy table, mode mirrors and launch counts
                equal, final cache and state bitwise; each journal loads
                and replays; on qwen3 (the reference test's model) at
                least one site in reuse and one on ragged, converged-window
                (steps 11-18) mac skip above 0.5, overflow fallbacks
                counted, a budget decision citing them (printed for rwkv6);
                prints
                the decisions, each capture and what moved its key, replay
                medians by span; the compiled step's decode variants are
                bounded (least recently used evicted past the cap): decode
                variants built, evictions, live variants and live pools
                against the unbounded baseline (budgets in the key, no
                cap); an interval whose only spec move is a budget must
                capture nothing, live pools stay under the cap times the
                largest decode pool, and qwen3 captures in fewer steps
                than that baseline's 10; then the guard's
                cost: the device→host copies of one Controller.step with
                and without the QuarantineBreaker (exactly one more with
                it) and the host ms of ctrl_snapshot with the sentinel
                lanes and without them; (b) phase 4's serve with --control-every 2
                --control-journal, eager-checked then as graphs, equal
                tokens, SensorReport lines, journal rows and control-plane
                line, bitwise final cache; per-layer final modes; (c) the
                basic-mode product at mlp_in's shape, one bf16 product with
                an f32 result against the widened form, checked and timed
  10. guard   — the guard plane (repro_torch.guard): (a) the reference's
                chaos test at qwen3's mlp_in shape (8 stacked layers, batch
                2, bf16 weights, integer-valued operands at fixed_scale 1.0
                so every f32 sum is exact): poison-nan into layer 0 after
                step 5, the Controller with the breaker every 2 steps, 14
                steps beside the basic-mode oracle, eagerly with every
                kernel call checked, then captured as CUDA graphs; bitwise
                equal runs; the NaN reaches step 6, steps 7-14 finite and
                bitwise the oracle, the journal chains quarantined ->
                probation -> active and replays, a run without injection
                trips nothing, the shadow check passes at that site;
                (b) phase 4's serve with --control-every 2 and --inject
                poison-nan into the last layer's mlp_out after step 3,
                eager-checked then as graphs: equal tokens, journal rows
                and final cache (bitwise), the trip at step 4 with check
                nonfinite_out, logits non-finite at step 4 only, the
                replay CLI OK, the serve without --inject trips nothing;
                then poison-sim, ctrl-garbage, poison-counters and stall
                through the graph serve cut to 2 layers, each tripping its
                own check (sim_range, ctrl_range, conservation, a
                stall_windows row); (c) the sentinel lanes' cost end to
                end: the graph serves with --refresh-every 2 and with
                --control-every 2 at 24 new tokens, the lanes in the
                breaker's snapshot alone and forced into every snapshot,
                in turns; the serve's ms a token over the replayed steps,
                each with the host work after it
  11. obs     — the observability plane (repro_torch.obs) on the compiled
                serve: (a) phase 4's serve with --obs-dir through the
                graphs: the latency table covers every site x {basic,
                kernel, ragged where gk >= 2}, each path 5 timed calls, and
                reads "compiled"; metrics.prom and metrics.jsonl parse back;
                one serve_step span per decode step; the same probe (f32
                weights, the reference's draws) run directly with every
                kernel call held against its plain version, its final site
                caches bitwise the graph probe's; per site and path the
                host p50 and the device ms between CUDA events; mlp_in's
                f32 kernel beside phase 3's bf16 one; (b) phase 4's serve
                with --control-every 2 --latency-table (a's table),
                eager-checked then graphs, equal tokens and journal rows;
                the lanes demoted against 9b's constant pricing; (c) the
                graph serve with --obs --profile-dir: the Chrome trace holds
                one serve_step range per step (kernels by name printed);
                (d) replicas.run, 2 replicas on repeat traffic, one wave
                of 2 requests x 32 tokens each: clean, no SLO alert;
                poison-sim at step 24 on r1, alerts naming r1 alone;
                fleet_report.json with 2 replicas; `python -m
                repro_torch.obs.top --fleet <out> --once` renders; each
                replica's tokens a second, variants, evictions and pools;
                then, as a diagnostic with no gate, the clean fleet of 4
                requests x 16 tokens, whose second wave starts at the
                interval of step 16: its alerts printed; and the trace of
                (c) names each of the port's kernels as often as the run
                launched it

  12. moe     — the MoE family and the compact path: (a) phase 4's traffic
                with --reuse on full-width mixtral-8x7b cut to 4 of 32
                layers (delta_quant and output-stationary must launch),
                eager-checked then graphs, held equal as phase 4's pair, the
                routed experts' bytes and bound beside a replay's busy time;
                then run_measured_decode at mixtral's operating point
                (correlation 0.9, batch 8, 12 steps), eager-checked then
                graphs, bitwise, skips per site; (b) the rolling window:
                mixtral as (a), dropless, batch 1, cache_len = window =
                4096, a 4088-token prompt and 16 decode steps without reuse,
                eager and as graphs bitwise, the KV cache slot for slot and
                the last logits against a windowed prefill of the same 4104
                tokens (relative L2 error a slot within 5e-2; the rolled
                slots must no longer hold their prompt positions; a token
                rerouted by a bf16 gate tie is held to the tie: top-k of
                its logits in both runs, its h moved within 5e-2); (c)
                phase 4's traffic with --reuse on full-width
                llama4-scout-17b-a16e cut to 2 of 48 layers (four reuse
                sites a layer, the shared expert's among them), as (a);
                (d) qwen3-32b (phase 4's config): run_measured_decode at
                correlation 0.95, batch 2, 24 steps, compact pinned at
                attn_qkv and mlp_in at a budget of ceil(gk/4),
                eager-checked then graphs, bitwise, layer 0 attn_qkv
                overflowing on some steps and not on others; phase 4's serve
                with --impl jnp (auto sites run dense: no ΔW GEMM kernel);
                the jnp tier's runner with the exec-path refresh after each
                step, promoting to compact; and compact timed beside kernel
                and ragged in
                phase 8a's sweep; (e) per-(slot, expert) expert reuse at
                mixtral width (one layer, batch 8, the reference test's
                stream): lanes and outputs against the quantized dense
                top-1 reference in f32, repeated slots skipping every tile
  13. archetypes — the remaining decoders at published widths, each with
                phase 4's traffic and --reuse as a pair (eager-checked,
                then the graph serve held equal; step times in turns, one
                profiled replay, parameter bytes against the card's
                memory): (a) zamba2-2.7b uncut (54 Mamba2 layers, 9
                applications of the shared attention block), then a Mamba
                check at 2 superblocks (32-token prefill + 16 decode steps
                against one prefill of the 48 tokens: h, conv, the shared
                block's KV cache, last logits); (b) gemma3-12b at 12 of 48
                layers, then its local window at 6 layers (batch 1, cache
                2048, a 1016-token prompt + 16 steps rolling the 1024-slot
                local caches, against a windowed prefill); (c) qwen2-72b at
                4 of 80 (mlp_out's K = 29568 ends inside a tile: the kernel
                gets the weight itself, and no replay kernel copies it),
                nemotron-4-15b at 8 of 32, qwen2-vl-7b at 8 of 28 (its
                mlp_out runs input-stationary); (d) the LM head: qwen3,
                llama4 and gemma3 steps replayed with the earlier widened
                head and with one bf16 product, in turns
  14. sharded — `serve --mesh host:4` (every reuse site's cache and weight
                in 4 model-axis shards on the card, each shard's GEMM on
                its column panel of the weight, read in place): (a)
                qwen3-32b at 8 layers and (b) qwen2-72b at 4 (mlp_in's
                panels end inside a tile), phase 4's traffic, each as a
                pair (eager-checked, then graphs), then bitwise the
                unsharded serve of phase 4 / 13c (tokens, SensorReport
                lines, decode state, reuse cache with prev_out's panels
                side by side and counters collapsed); the no-gather, shard
                skip and ici traffic lines; each site's 4 panel launches
                timed against its one unsharded launch; 14b: no step copies
                a weight-sized tensor; (c) the serve with --control-every 2
                --control-journal at 16 tokens: kind="shard" rows, replay,
                Controller.step's 2 (3 with the breaker) device->host
                copies, and a NaN in shard 2's lane of mlp_out tripping the
                breaker's combined sentinels
  15. ckpt    — checkpointing on qwen3-32b at 8 layers, phase 4's traffic:
                (a) a save (`--control-every 2`, a table pinning
                attn_qkv's sim_threshold, `--cache-ckpt`): step directory,
                sidecar, marker, hashes, manifest paths (the cache's
                without mode_host), every stored leaf bitwise the final
                live cache; (b) the restore without the table as a pair
                (eager-checked, then graphs, each from a copy): restore
                lines and kind="restore" journal rows that replay, the
                cache before the first step bitwise the checkpoint in the
                tensors init_cache built, mode_host equal to the mode
                lanes; (c) a `--inject corrupt-ckpt` save whose next start
                raises CorruptCheckpointError before any capture; (d) the
                round trip at `--mesh host:4` (prev_out stored [L, 4, B,
                N/4]); save, verify and restore timed on both caches; (e)
                phase 4's serve with kv_cache_quant=True as a pair: int8
                K/V at half the bf16 bytes, a prefill's codes bitwise the
                bf16 prefill's K/V quantized, the replay beside phase 4's

  16. train   — training at full width, cut in depth: (a) qwen3-32b at 4
                of 64 layers, batch 8, seq 128, correlation 0.9: 6 steps
                straight, against `launch.train.run` for 3 steps under
                ResilientLoop (its checkpoint after step 0), the state
                dropped, and `--resume` to step 6: parameters bitwise; the
                f32_product gradient against the f32 product's; (b)
                rwkv6-7b at 8 of 32 layers: every wkv6_decode and
                wkv6_decode_backward call of 2 steps against its plain
                version, layer 0's WKV6Sequence gradient against autograd
                through the plain steps, then 6 steps timed; (c)
                hubert-xlarge uncut on SyntheticAudioSource: a finite,
                falling loss. Each cell's step ms, tokens/s, model-FLOPs
                share, peak memory and device busy share (one profiled
                step); wkv6_decode_backward at [8,64,64]x64x64 checked and
                timed beside its bound and its plain version

Each phase prints its seconds. Before the last line it prints a JSON line of
the graph serves (step times both ways, variants, captures, capture seconds,
pools, device busy and idle share), a JSON line of phase 8 (its runs, the
sweep, the break-even and the fitted tables), JSON lines of phase 9 (the
closed loops; the controlled serve and the basic-mode product) and of
phase 10, a JSON line of phase 11, a JSON line of phase 12, a JSON line
of phase 13, a JSON line of phase 14, a JSON line of phase 15, a JSON line
of phase 16, the kernels JSON line (launch counts from the serve runs, the
int8 path and the rwkv6 training run, and per phase 8-16 run; errors and
times from phases 3 and 16)
and the card's name and power limit; the last line is {"ok": true,
"device": {...}}. The controlled, guarded and checkpointing serves' whole
output goes to chiprun_out/chip_smoke/.
Exits non-zero when no CUDA device is available, and when the repository's
package is not beside it.
"""

from __future__ import annotations

import collections
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
import shutil
import statistics
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
# their f32 operands on CUDA cores in IEEE f32; delta_quant, wkv6_decode and
# wkv6_decode_backward on CUDA cores.
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
    # no TPU kernel: the gradient of wkv6_decode's step, which the
    # reference leaves to XLA's differentiation of its lax.scan
    "wkv6_decode_backward": (
        "src/repro_torch/csrc/wkv6_backward.cu",
        "none (the gradient of src/repro/kernels/wkv6_decode.py:71)"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


_PHASE = {"name": None, "t0": 0.0}


def phase(name: str | None) -> None:
    """Start the phase `name` (None: the end), printing the seconds the
    previous one took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"(phase {_PHASE['name']}: {now - _PHASE['t0']:.1f} s)",
              flush=True)
    _PHASE.update(name=name and name.split()[0].rstrip("."), t0=now)
    if name is not None:
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


class PoisonedPathCheck(PathCheck):
    """PathCheck for a run with an injected NaN (phase 10a): a ΔW GEMM whose
    prev_out holds the NaN must carry it to exactly the positions where its
    plain version carries it, and every other element is held to the usual
    tolerance."""

    def reuse_matmul(self, *args, impl, dataflow, **kw):
        if bool(torch.isfinite(args[2]).all()):
            return super().reuse_matmul(*args, impl=impl, dataflow=dataflow,
                                        **kw)
        got = self.orig["reuse_matmul"](*args, impl=impl, dataflow=dataflow,
                                        **kw)
        want = self.orig["reuse_matmul"](*args, impl="torch",
                                         dataflow=dataflow, **kw)
        kname = f"reuse_matmul_{dataflow}"
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin):
            fail(f"poisoned path: {kname} puts non-finite values elsewhere "
                 "than its plain version")
        self._note(kname, close(got[fin], want[fin], GEMM_ATOL, GEMM_RTOL,
                                f"poisoned path: {kname}"))
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


def profile_step(fn, what: str, *, grad: bool = False) -> tuple:
    """Where one step's time goes: device time by kernel name
    (torch.profiler, CUPTI) against the host wall time of the step (a
    decode step under no_grad; a training step, `grad`, with autograd).
    Returns (wall ms, device busy ms, the kernel rows of
    `key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.nullcontext() if grad else torch.no_grad():
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: CPU-op rows carry their children's device time too
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    rows.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3
    print(f"  profile of {what}: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms ({busy / wall:.1%}), idle share "
          f"{max(0.0, 1 - busy / wall):.1%}; "
          f"{sum(e.count for e in rows)} kernels and copies")
    # the top rows, and delta_quant's wherever it ranks
    for e in rows[:12] + [e for e in rows[12:] if "delta_quant" in e.key]:
        print(f"    {e.device_time_total / 1e3:8.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return wall, busy, rows


def tensor_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} of every tensor leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tensor_leaves(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def outcome(res, text: str) -> dict:
    """What the two serves of a pair must hold equal: each request's tokens,
    the SensorReport lines, the mode mirrors, and every tensor of the final
    reuse cache and decode state (cloned)."""
    step = res["step"]
    return {
        "tokens": {r.rid: list(r.output) for r in res["done"]},
        "reports": [ln for ln in text.splitlines()
                    if ln.startswith("SensorReport rid=")]
        + res["report"].summary_lines(),
        "modes": {n: e["mode_host"].tobytes() for n, e in step.rcache.items()},
        "tensors": {k: t.clone() for k, t in tensor_leaves(
            {"rcache": step.rcache, "state": step.state}).items()},
    }


def step_times(step, pairs: int) -> tuple[list, list]:
    """Decode step times in ms (host clock around synchronize) on the graph
    serve's buffers after its run: the step function run eagerly, and its
    graph replayed, in turns (eager, graph, graph, eager, ...)."""
    sync = torch.cuda.synchronize
    step.decode(step.tokens)  # builds the variant of the current key if new
    times = {"eager": [], "graph": []}
    runs = {"eager": step.run_decode, "graph": lambda: step.decode(step.tokens)}
    for i in range(pairs):
        for how in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                runs[how]()
            sync()
            times[how].append((time.perf_counter() - t0) * 1e3)
    return times["eager"], times["graph"]


def flip_hook():
    """A forced mode flip of attn_out's layer-0 lane after decode step 1 and
    its flip back after step 3 (between policy refreshes at even steps), the
    same in both serves of a pair. Logs, after each step, the index of the
    next step's decode key among the keys seen and whether a variant of it
    exists already (False: the next step captures one)."""
    log = {"keys": [], "seq": []}

    def index(key):
        if key not in log["keys"]:
            log["keys"].append(key)
        return log["keys"].index(key)

    def hook(i, step):
        entry = step.rcache["attn_out"]
        if i == 1:
            index(step.decode_key())  # the key step 1 ran with
            log["orig"] = "reuse" if int(entry["mode_host"][0]) else "basic"
            flip = {"reuse": "basic", "basic": "reuse"}[log["orig"]]
            step.engine.set_mode(step.rcache, "attn_out", flip, layer=0)
        elif i == 3:
            step.engine.set_mode(step.rcache, "attn_out", log["orig"], layer=0)
        key = step.decode_key()
        log["seq"].append((i, index(key), key in step.variants))
    return hook, log


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


# phase 8: the skip sweep at every serve site shape, and the measured-decode
# runs on the reference runner's correlated stream (correlation 0.95, as its
# MEASURED_OPERATING_POINTS), recorded, fitted and exploited
SWEEP_SKIPS = (0.0, 0.25, 0.5, 0.75, 0.9)
CORRELATION, MEASURED_SEED = 0.95, 0
# decode steps a run: rwkv6's 32-layer eager step under the per-call checks
# takes about a second, so it runs fewer
MEASURED_STEPS = {"qwen3-32b": 24, "rwkv6-7b": 12}
# the three float ΔW GEMMs are one template, `cluster_gemm`, named in a
# profile by its tile list
GEMM_LISTS = {"MaskList": "reuse_matmul_output",
              "InputList": "reuse_matmul_input",
              "RaggedList": "reuse_matmul_ragged"}


def skip_sweep(dev, gen, max_err) -> dict:
    """Phase 8a. At every serve site shape (M = 8, bf16) and skip in
    SWEEP_SKIPS: the site's masked kernel (output- or input-stationary), the
    ragged kernel (its live counts checked against the budget
    `ReusePolicy.ragged_budget(gk, skip)`) and the dense yardstick
    `torch.addmm(prev, Δ, W, out_dtype=f32)`, each kernel held against its
    plain version, then timed with the weight rotated through
    ROTATE_BYTES. Two crossings a shape from `derive_break_even_skip`: the
    best reuse kernel against dense (as the reference's sweep feeds it),
    and ragged against the masked kernel. Returns {model: [row, ...]}."""
    from repro_torch.core.delta import compact_rows
    from repro_torch.core.policy import ReusePolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels.reuse_matmul import (
        reuse_matmul,
        reuse_matmul_torch,
    )
    from repro_torch.kernels.reuse_matmul_ragged import (
        reuse_matmul_ragged,
        reuse_matmul_ragged_torch,
    )
    from repro_torch.tune.harvest import derive_break_even_skip

    out = {}
    compact_err = 0.0
    print(f"skip sweep, ms per call (CUDA-graph replay of 20 calls, weight "
          f"rotated through {ROTATE_BYTES / 1e6:.0f} MB), M = {M}, bf16; "
          "kernel = the site's masked kernel, ragged at the budget "
          "ragged_budget(gk, skip), compact = ops.reuse_matmul_compact (the "
          "plain product in torch ops, full K), dense = "
          "torch.addmm:")
    for model, shapes in (("qwen3-32b", SITES), ("rwkv6-7b", RWKV_SITES)):
        rows = out[model] = []
        for site, k, n, dataflow in shapes:
            gk = k // BK
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            copies = math.ceil(ROTATE_BYTES / (w.numel() * w.element_size()))
            nxt = itertools.cycle([w] + [w.clone() for _ in range(copies - 1)])
            wn = nxt.__next__
            kname = f"reuse_matmul_{dataflow}"
            pts = []
            for skip in SWEEP_SKIPS:
                mask = random_mask(1, gk, skip, gen, dev)
                delta = (torch.randn((M, k), generator=gen, device=dev)
                         * expand(mask, BM, BK)).to(torch.bfloat16)
                prev = torch.randn((M, n), generator=gen, device=dev)
                idx, counts = compact_rows(mask)
                budget = ReusePolicy.ragged_budget(gk, skip)
                if int(ops.budget_overflow(counts, gk=gk,
                                           max_active_k=budget)):
                    fail(f"sweep {site} skip {skip}: live tiles overflow the "
                         f"budget {budget}")
                ref = reuse_matmul_torch(delta, w, prev, mask, block_m=BM,
                                         block_k=BK)
                got = reuse_matmul(delta, w, prev, mask, block_m=BM,
                                   block_n=BN, block_k=BK, dataflow=dataflow)
                max_err[kname] = max(max_err[kname], close(
                    got, ref, GEMM_ATOL, GEMM_RTOL, f"sweep {site} {kname}"))
                want = reuse_matmul_ragged_torch(
                    delta, w, prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK)
                got = reuse_matmul_ragged(delta, w, prev, counts, idx,
                                          block_m=BM, block_n=BN, block_k=BK)
                max_err["reuse_matmul_ragged"] = max(
                    max_err["reuse_matmul_ragged"],
                    close(got, want, GEMM_ATOL, GEMM_RTOL,
                          f"sweep {site} reuse_matmul_ragged"))
                t_k = time_ms(lambda: reuse_matmul(
                    delta, wn(), prev, mask, block_m=BM, block_n=BN,
                    block_k=BK, dataflow=dataflow))
                t_r = time_ms(lambda: reuse_matmul_ragged(
                    delta, wn(), prev, counts, idx, block_m=BM, block_n=BN,
                    block_k=BK))
                kmask = mask.amax(dim=0)
                got = ops.reuse_matmul_compact(delta, w, prev, kmask,
                                               block_k=BK)
                compact_err = max(compact_err, close(
                    got, ref, GEMM_ATOL, GEMM_RTOL, f"sweep {site} compact"))
                t_c = time_ms(lambda: ops.reuse_matmul_compact(
                    delta, wn(), prev, kmask, block_k=BK))
                t_d = time_ms(lambda: torch.addmm(prev, delta, wn(),
                                                  out_dtype=torch.float32))
                active = int(mask.sum())
                byts = (active * BK * n * 2 + delta.numel() * 2
                        + 2 * M * n * 4 + mask.numel() * 4)
                bound = max(byts / HBM_BYTES_PER_S,
                            2 * M * n * active * BK / BF16_FLOPS) * 1e3
                pts.append({"skip": skip, "budget": budget, "kernel_ms": t_k,
                            "ragged_ms": t_r, "compact_ms": t_c,
                            "dense_ms": t_d, "bound_ms": bound})
            del nxt, wn, w
            be = derive_break_even_skip(
                [(p["skip"], min(p["kernel_ms"], p["ragged_ms"]),
                  p["dense_ms"]) for p in pts])
            rk = derive_break_even_skip(
                [(p["skip"], p["ragged_ms"], p["kernel_ms"]) for p in pts])
            rows.append({"site": site, "shape": f"[{M},{k}]x[{k},{n}]",
                         "kernel": kname, "points": pts, "break_even": be,
                         "ragged_over_kernel": rk})
            print(f"  {model} {site:9s} [{M},{k}]x[{k},{n}] {kname}: "
                  + "; ".join(f"skip {p['skip']:.2f} kernel "
                              f"{p['kernel_ms']:.4f} ragged@{p['budget']} "
                              f"{p['ragged_ms']:.4f} compact "
                              f"{p['compact_ms']:.4f} dense "
                              f"{p['dense_ms']:.4f} bound {p['bound_ms']:.4f}"
                              for p in pts))
            print(f"    crossings: best reuse kernel vs dense {be:.4f}, "
                  f"ragged vs {kname} {rk:.4f} (2.0 = never)")
    print(f"compact against the plain masked product at every shape and "
          f"skip: max err {compact_err:.3e}")
    return out


def gpu_clocks() -> str:
    """The card's SM and memory clocks and power draw, as nvidia-smi reads
    them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


@contextlib.contextmanager
def timed_decodes(profile_at, what: str):
    """Times each decode step of the measured-decode run inside it (host
    clock around synchronize) by wrapping `CompiledStep.decode`, and the
    host time until the call returns (the token copy, the key and the
    graph launch, before the device is waited for); the decodes numbered in
    `profile_at` (1-based) are profiled instead. Yields a log: per decode
    its ms and host ms (None: profiled) and whether it captured a variant,
    per replay the host time of the graph launch alone
    (`CompiledStep.replay`), and the profiles (wall ms, busy ms, kernel
    rows): "profile" the last, "profiles" by decode number."""
    from repro_torch.serve.compiled_step import CompiledStep

    orig, orig_replay = CompiledStep.decode, CompiledStep.replay
    log = {"ms": [], "host_ms": [], "launch_ms": [], "captured": [],
           "profile": None, "profiles": {}}

    def replay(self, v, key):
        t0 = time.perf_counter()
        out = orig_replay(self, v, key)
        log["launch_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def decode(self, tokens):
        before = self.captures
        ms = host = None
        n = len(log["ms"]) + 1
        if n in profile_at:
            box = []
            log["profile"] = log["profiles"][n] = profile_step(
                lambda: box.append(orig(self, tokens)), f"{what} (step {n})")
            out = box[0]
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(self, tokens)
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        log["ms"].append(ms)
        log["host_ms"].append(host)
        log["captured"].append(self.captures != before)
        return out

    CompiledStep.decode, CompiledStep.replay = decode, replay
    try:
        yield log
    finally:
        CompiledStep.decode, CompiledStep.replay = orig, orig_replay


def measured_pair(label, arch, cfg, params, *, steps, batch, policy, dev,
                  max_err, correlation=CORRELATION, **run_kw):
    """Phase 8b and 8d: `run_measured_decode` three times on one seed and
    stream: eagerly (`graphs=False`) with every kernel call held against its
    plain version (PathCheck); through the CUDA graphs of the compiled step
    with each decode timed (no profiler in that run, the card's clocks read
    before and after); and through the graphs again with the middle decode
    profiled. Summary lines, JSONL rows, launch counts, mode mirrors and
    every tensor of the final reuse cache and decode state must be equal
    (bitwise) in all three. `policy()` makes each run's policy; `run_kw`
    goes to the runner as it is (impl, refresh_policy). Returns (the timed
    run's MeasuredDecode, its launch counts, its decode log with the
    profiled run's profile)."""
    from repro_torch.kernels import backend, ops
    from repro_torch.sensor.runner import run_measured_decode

    kw = dict(steps=steps, batch=batch, correlation=correlation,
              seed=MEASURED_SEED, device=dev, params=params, cfg=cfg,
              **run_kw)
    runs, logs = [], []
    for how in ("eager", "timed", "profiled"):
        gc.collect()
        torch.cuda.empty_cache()
        backend.reset_launches()
        if how == "eager":
            ctx = PathCheck(ops)
        else:
            ctx = timed_decodes((steps // 2 + 1,) if how == "profiled"
                                else (), f"{label}: one replay")
        clocks = gpu_clocks() if how == "timed" else None
        with ctx as got:
            md = run_measured_decode(arch, policy=policy(),
                                     graphs=how != "eager", **kw)
        torch.cuda.synchronize()
        counts = backend.launch_counts()
        if how == "timed":
            print(f"{label}: card clocks (sm, mem, power) before the timed "
                  f"graph run: {clocks}; after: {gpu_clocks()}")
            timed = md, counts
        if how == "eager":
            if got.checked != counts:
                fail(f"{label}: kernel calls checked {got.checked} != "
                     f"launches {counts}")
            for kn, n in got.checked.items():
                if n:
                    max_err[kn] = max(max_err[kn], got.max_err[kn])
        else:
            if not got["captured"][0]:
                fail(f"{label}: the {how} graph run did not capture its "
                     "first step")
            logs.append(got)
        runs.append({
            "lines": md.report.summary_lines(), "rows": md.report.to_dicts(),
            "counts": counts,
            "modes": {n: e["mode_host"].tobytes() for n, e in md.cache.items()},
            "tensors": {k: t.clone() for k, t in tensor_leaves(
                {"rcache": md.cache, "state": md.step.state}).items()}})
        del md
    want = runs[0]
    for how, got in zip(("timed", "profiled"), runs[1:]):
        for part in ("lines", "rows", "counts", "modes"):
            if got[part] != want[part]:
                fail(f"{label}: the {how} graph run's {part} differ from the "
                     "checked eager run's")
        diff = [k for k, t in want["tensors"].items()
                if not torch.equal(t, got["tensors"][k])]
        if diff:
            fail(f"{label}: the {how} graph run's final reuse cache / decode "
                 f"state differ at {diff[:8]} ({len(diff)} tensors)")
    print(f"{label}: both graph runs equal to the checked eager run — "
          f"{len(want['lines'])} summary lines, {len(want['rows'])} JSONL "
          f"rows, launch counts {want['counts']}, {len(want['tensors'])} "
          "tensors of the final reuse cache and decode state bitwise; every "
          "kernel call of the eager run held against its plain version")
    log = dict(logs[0], profile=logs[1]["profile"])
    return timed[0], timed[1], log


def measured_summary(label, md, counts, log, ref=None,
                     correlation=CORRELATION) -> dict:
    """Prints a measured-decode run's per-site skips, its replay step times
    (captures and the profiled step left out), the ΔW GEMMs' device ms of
    the profiled replay beside `sensor_speedup` on the card's datasheet
    rates, and returns the run's row for the JSON line. `ref` is (what,
    ms): a replay time to print beside this run's."""
    from repro_torch.sensor.cost_model import sensor_speedup

    rep, steps = md.report, md.steps
    m = rep.model
    print(f"{label}: {steps} decode steps at batch {md.batch}, correlation "
          f"{correlation}, seed {MEASURED_SEED}; model tile_skip "
          f"{m['tile_skip_rate']:.4f} mac_skip {m['mac_skip_rate']:.4f} "
          f"weight_byte_skip {m['weight_byte_skip_rate']:.4f} hit_rate "
          f"{m['hit_rate']:.4f}")
    sites = {}
    for s in rep.per_site:
        sites[s.site] = {"exec_path": s.exec_path, "block_k": s.block_k,
                         "tile_skip": s.tile_skip_rate,
                         "mac_skip": s.mac_skip_rate,
                         "weight_byte_skip": s.weight_byte_skip_rate,
                         "hit_rate": s.hit_rate}
        print(f"  {s.site:13s} exec={s.exec_path:6s} block_k={s.block_k:3d} "
              f"tile_skip={s.tile_skip_rate:.4f} "
              f"mac_skip={s.mac_skip_rate:.4f} "
              f"weight_byte_skip={s.weight_byte_skip_rate:.4f} "
              f"hit={s.hit_rate:.4f} grid_skip={s.grid_step_skip_rate:.4f}")
    first = rep.per_layer[0]
    print(f"  layer 0 {first.site}: tile_skip {first.tile_skip_rate:.4f} "
          f"({first.skipped_tiles} of {first.total_tiles} tiles)")
    if first.site == "attn_qkv" and first.skipped_tiles == 0:
        fail(f"{label}: layer 0 attn_qkv skipped no tile on the correlated "
             "stream")
    replays = [t for t, cap in zip(log["ms"], log["captured"]) if not cap]
    hosts = [t for t, cap in zip(log["host_ms"], log["captured"]) if not cap]
    med = statistics.median(replays)
    launch = statistics.median(log["launch_ms"] or [math.nan])
    print(f"{label}: replay step (host clock around synchronize, "
          f"{len(replays)} replays, no profiler): median {med:.2f} ms ("
          + ", ".join(f"{t:.2f}" for t in replays) + ")"
          + (f"; {ref[0]}: {ref[1]:.2f} ms" if ref else "")
          + f"; host time until the decode call returns: median "
          f"{statistics.median(hosts):.2f} ms (max {max(hosts):.2f}), of it "
          f"the graph launch (replay()) median {launch:.2f} ms")
    # the final key's step timed as phases 4-6 time theirs: the step
    # function eagerly and its graph replayed, in turns, on the run's
    # buffers after its last step (the token buffer holds the last token)
    eager, graph = step_times(md.step, 3)
    print(f"{label}: the final key's step in turns as phases 4-6 time it: "
          f"eager median {statistics.median(eager):.2f} ms, graph replay "
          f"median {statistics.median(graph):.2f} ms ("
          + ", ".join(f"{t:.2f}" for t in graph) + ")")
    _, busy, rows = log["profile"]
    gemm = {kn: 0.0 for kn in GEMM_LISTS.values()}
    for e in rows:
        if "cluster_gemm" in e.key:
            kn = next(v for k, v in GEMM_LISTS.items() if k in e.key)
            gemm[kn] += e.device_time_total / 1e3
    dw = sum(gemm.values())
    sp = sensor_speedup(rep)
    base_ms, meas_ms = (sp[k] / steps * 1e3
                        for k in ("baseline_site_s", "measured_site_s"))
    print(f"{label}: ΔW GEMMs in the profiled replay {dw:.3f} ms of "
          f"{busy:.3f} ms busy ("
          + ", ".join(f"{k} {v:.3f}" for k, v in gemm.items() if v)
          + f"); sensor_speedup per step on the H100 datasheet rates: dense "
          f"{base_ms:.4f} ms, measured {meas_ms:.4f} ms, site speedup "
          f"{sp['site_speedup']:.3f}x")
    return {"run": label, "batch": md.batch, "steps": steps,
            "tile_skip": m["tile_skip_rate"], "mac_skip": m["mac_skip_rate"],
            "weight_byte_skip": m["weight_byte_skip_rate"],
            "hit_rate": m["hit_rate"], "sites": sites,
            "replay_ms": med, "replays_ms": replays, "ref": ref,
            "host_ms": statistics.median(hosts),
            "launch_ms": launch,
            "turns_graph_ms": statistics.median(graph),
            "turns_eager_ms": statistics.median(eager),
            "busy_ms": busy, "dw_gemm_ms": dw, "dw_gemm_by_kernel": gemm,
            "speedup_dense_ms": base_ms, "speedup_measured_ms": meas_ms,
            "site_speedup": sp["site_speedup"], "launches": dict(counts)}


def measured_decode_phase(cfg, rcfg, dev, graph_rows, max_err) -> dict:
    """Phase 8 on the configs of phases 4 (qwen3 `cfg`) and 6 (rwkv6
    `rcfg`): (a) the skip sweep and the measured break-even; (b) record:
    measured decode on the correlated stream, eager-checked and as graphs;
    (c) fit: the record's JSONL through load_trace, fit_trace at the
    measured gate for the kernel tier, save_table, load_tuned_policy; (d)
    exploit: the same stream on the tuned policy, eager-checked and as
    graphs. Prints a JSON line of the runs; returns {run: launch counts}."""
    from repro_torch.core.policy import ReusePolicy
    from repro_torch.models import init_params
    from repro_torch.tune import (
        FitConfig,
        fit_trace,
        load_trace,
        load_tuned_policy,
        save_table,
    )
    from repro_torch.tune.fit import summary_lines as fit_summary_lines

    gc.collect()
    torch.cuda.empty_cache()
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(4)
    sweep = skip_sweep(dev, gen_s, max_err)
    # one gate a model: the largest crossing of its shapes, so a site is
    # promoted only at a skip where the reuse kernels beat dense on each
    break_even = {model: max(r["break_even"] for r in rows)
                  for model, rows in sweep.items()}
    print("measured break-even skip (best reuse kernel vs dense, the largest "
          "of the model's shapes; the fit's ragged_min_skip and the policy's "
          "ragged_break_even_skip): "
          + ", ".join(f"{k} {v:.4f}" for k, v in break_even.items())
          + "; RAGGED_BREAK_EVEN_SKIP stays the reference's "
          f"{ReusePolicy().ragged_break_even_skip}")
    replay_ref = {r["serve"]: r["graph_ms"] for r in graph_rows}
    measured, launches_measured, fitted = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, mcfg, ref_label, ref_phase in (
                ("qwen3-32b", cfg, "qwen3 default", 4),
                ("rwkv6-7b", rcfg, "rwkv6", 6)):
            gc.collect()
            torch.cuda.empty_cache()
            params = init_params(mcfg, MEASURED_SEED, device=dev)
            steps = MEASURED_STEPS[arch]
            # (b) record: batch 8, and qwen3 also at the reference runner's
            # default batch 2
            for batch in ((8, 2) if arch == "qwen3-32b" else (8,)):
                label = f"{arch} b{batch} record"
                print(f"--- {label}")
                md, counts, log = measured_pair(
                    label, arch, mcfg, params, steps=steps, batch=batch,
                    policy=lambda: None, dev=dev, max_err=max_err)
                measured.append(measured_summary(
                    label, md, counts, log,
                    (f"random-traffic replay of phase {ref_phase}",
                     replay_ref[ref_label]) if batch == 8 else None))
                launches_measured[label] = counts
                if batch == 8:
                    record, record_ms = md, measured[-1]["replay_ms"]
                del md
            for kn in (("delta_quant", "reuse_matmul_output",
                        "reuse_matmul_input") if arch == "qwen3-32b" else
                       ("delta_quant", "reuse_matmul_output", "wkv6_decode")):
                if launches_measured[f"{arch} b8 record"][kn] <= 0:
                    fail(f"{kn} was not launched in the {arch} record run")
            # (c) fit: the record's JSONL, loaded, fitted for the card's
            # kernel tier at the measured gate, saved and loaded as a policy
            be = break_even[arch]
            trace_path = os.path.join(tmp, f"{arch}_trace.jsonl")
            record.report.write_jsonl(trace_path, mode="w")
            del record
            trace = load_trace(trace_path)
            tunables = fit_trace(trace, FitConfig(pallas_target=True,
                                                  ragged_min_skip=be))
            table = os.path.join(tmp, f"{arch}_tuned.json")
            save_table(table, tunables, meta={
                "trace": os.path.basename(trace_path),
                "n_rows": trace.n_rows, "ragged_min_skip": be})
            print(f"{arch} fit (FitConfig(pallas_target=True, "
                  f"ragged_min_skip={be:.4f})), from {trace.n_rows} rows:")
            print("\n".join(fit_summary_lines(trace, tunables)))
            fitted[arch] = {name: t.to_dict() for name, t in tunables.items()
                            if name in trace.sites}
            # beside it, the gate the other crossing would give: ragged
            # against the masked kernel (not served; printed only)
            rk = max(r["ragged_over_kernel"] for r in sweep[arch])
            alt = fit_trace(trace, FitConfig(pallas_target=True,
                                             ragged_min_skip=rk))
            print(f"{arch}: with the ragged-over-kernel crossing as the gate "
                  f"({rk:.4f}) the fit would promote "
                  f"{[n for n in trace.sites if alt[n].exec_path] or 'no site'}")
            base = ReusePolicy(ragged_break_even_skip=be)
            # (d) exploit: the same seed and stream on the tuned policy
            label = f"{arch} b8 exploit"
            print(f"--- {label}")
            md, counts, log = measured_pair(
                label, arch, mcfg, params, steps=steps, batch=8,
                policy=lambda: load_tuned_policy(table, base=base), dev=dev,
                max_err=max_err)
            measured.append(measured_summary(
                label, md, counts, log, ("the record's replay", record_ms)))
            launches_measured[label] = counts
            for name, spec in md.engine.sites.items():
                t = tunables[name]
                if spec.exec_path != (t.exec_path or "auto") or (
                        t.block_k is not None and spec.block_k != t.block_k):
                    fail(f"{label}: site {name} runs exec "
                         f"{spec.exec_path} block_k {spec.block_k}, not the "
                         "fitted table's")
            promoted = [n for n, t in tunables.items()
                        if n in trace.sites and t.exec_path == "ragged"]
            print(f"{label}: fitted exec paths promote {promoted or 'no site'}"
                  " to ragged; replay "
                  f"{measured[-1]['replay_ms']:.2f} ms against the record's "
                  f"{record_ms:.2f} ms")
            if promoted and counts["reuse_matmul_ragged"] <= 0:
                fail(f"{label}: promoted sites but reuse_matmul_ragged was "
                     "not launched")
            del md, params
    print(json.dumps({"measured_decode": measured, "sweep": sweep,
                      "break_even": break_even, "fitted": fitted}))
    return launches_measured


# phase 9: the online control plane (repro_torch.control) on the reference's
# acceptance scenario for it (tests/test_control.py::test_closed_loop_
# control_matches_tuned_baseline): from the default policy, a fully anchored
# stream converges, then a dissimilarity burst must widen a budget
CONTROL_STEPS, CONTROL_BATCH, CONTROL_BURST = 26, 2, (19, 22)
CONTROL_SPANS = (("1-10", 1, 10), ("11-18", 11, 18), ("burst 19-22", 19, 22),
                 ("23-26", 23, 26))
# the closed loop on a compiled step with budgets in the decode key and no
# cap on live variants: (capture steps, MB of pools), measured on NVIDIA H100
# 80GB HBM3 at 700.00 W (PERF.md §6)
UNBOUNDED_BASELINE = {"qwen3-32b": (10, 6944), "rwkv6-7b": (6, 3362)}


@contextlib.contextmanager
def recorded_tokens():
    """The greedy tokens of every decode of the run inside it, taken from
    the logits `CompiledStep.decode` returns (kept on the card)."""
    from repro_torch.serve.compiled_step import CompiledStep

    orig = CompiledStep.decode
    toks = []

    def decode(self, tokens):
        out = orig(self, tokens)
        toks.append(out.argmax(dim=-1))
        return out

    CompiledStep.decode = decode
    try:
        yield toks
    finally:
        CompiledStep.decode = orig


def controlled_decode(arch, cfg, params, dev, journal, graphs):
    """`run_measured_decode` on the acceptance scenario with the port's
    Controller every 2 steps (`min_window_steps=2`, journal at `journal`)
    from the default policy. Returns (controller, run, sensor reports after
    steps 10 and 18: the converged window's bounds)."""
    from repro_torch.control import ControlConfig, Controller
    from repro_torch.sensor.runner import run_measured_decode

    ctl = Controller(ControlConfig(min_window_steps=2, journal_path=journal))
    windows = {}

    def on_step(i, engine, cache):
        if i % 2 == 0:
            ctl.step(engine, cache, step=i)
        if i in (10, 18):
            windows[i] = engine.sensor_report(cache)

    md = run_measured_decode(
        arch, steps=CONTROL_STEPS, batch=CONTROL_BATCH, correlation=1.0,
        seed=MEASURED_SEED, burst=CONTROL_BURST, on_step=on_step, device=dev,
        params=params, cfg=cfg, graphs=graphs)
    return ctl, md, windows


def gemm_ms(rows) -> float:
    """Device ms of the ΔW GEMMs (the cluster tile loop) among a profile's
    kernel rows."""
    return sum(e.device_time_total for e in rows
               if "cluster_gemm" in e.key) / 1e3


def control_pair(label, arch, cfg, params, dev, max_err, tmp) -> dict:
    """Phase 9a on one model: the controlled run three times on one seed
    and stream — eagerly with every kernel call held against its plain
    version (PathCheck), through the CUDA graphs with each decode timed,
    and through the graphs again with a converged and a burst replay
    profiled (the steps the timed run replayed). Tokens, journal rows
    (without `ts`), final specs, policy table, mode mirrors and launch
    counts equal in all three, the final reuse cache and decode state
    bitwise; each journal loads and replays; on qwen3 the reference
    test's four properties hold. Returns the row of the JSON line."""
    from repro_torch.control import load_journal, replay_rows
    from repro_torch.kernels import backend, ops
    from repro_torch.serve.compiled_step import summary_line

    runs, profile_at = [], ()
    for how in ("eager", "timed", "profiled"):
        gc.collect()
        torch.cuda.empty_cache()
        backend.reset_launches()
        journal = os.path.join(tmp, f"{arch}_{how}.jsonl")
        ctx = (PathCheck(ops) if how == "eager" else
               timed_decodes(profile_at if how == "profiled" else (),
                             f"{label}: one replay"))
        with ctx as got, recorded_tokens() as toks:
            ctl, md, windows = controlled_decode(arch, cfg, params, dev,
                                                 journal, how != "eager")
        torch.cuda.synchronize()
        counts = backend.launch_counts()
        if how == "eager":
            if got.checked != counts:
                fail(f"{label}: kernel calls checked {got.checked} != "
                     f"launches {counts}")
            for kn, n in got.checked.items():
                if n:
                    max_err[kn] = max(max_err[kn], got.max_err[kn])
        rows = load_journal(journal)
        replayed = replay_rows(rows)
        if not replayed.ok:
            fail(f"{label}: the {how} run's journal does not replay:\n"
                 + "\n".join(ln for ln in replayed.summary_lines()
                             if "MISMATCH" in ln))
        runs.append({
            "tokens": torch.stack(toks).cpu().tolist(),
            "rows": [{k: v for k, v in r.items() if k != "ts"} for r in rows],
            "specs": dict(md.engine.sites),
            "table": {k: t.to_dict()
                      for k, t in md.engine.policy.site_tunables.items()},
            "modes": {n: e["mode_host"].tobytes() for n, e in md.cache.items()},
            "counts": counts,
            "tensors": {k: t.clone() for k, t in tensor_leaves(
                {"rcache": md.cache, "state": md.step.state}).items()}})
        if how == "timed":
            log, summ, win = got, md.step.summary(), windows
            # capture seconds and pool bytes of every decode variant built,
            # evicted ones included
            variants = [(sec, pool) for kind, sec, pool in md.step.built
                        if kind == "decode"]
            prefill_pool = sum(pool for kind, _, pool in md.step.built
                               if kind == "prefill")
            engine, cache, report = md.engine, md.cache, md.report
            # the profiled run profiles a replay near step 15 and one in the
            # burst, steps this (equal) run replayed
            replays = [i + 1 for i, c in enumerate(got["captured"]) if not c]
            conv = min((i for i in replays if 11 <= i <= 18),
                       key=lambda i: abs(i - 15), default=None)
            burst = next((i for i in replays
                          if CONTROL_BURST[0] <= i <= CONTROL_BURST[1]), None)
            profile_at = tuple(i for i in (conv, burst) if i is not None)
        if how == "profiled":
            profiles = got["profiles"]
            if any(got["captured"][i - 1] for i in profiles):
                fail(f"{label}: a profiled step captured instead of replaying")
        del ctl, md
    want = runs[0]
    for how, run in zip(("timed", "profiled"), runs[1:]):
        for part in ("tokens", "rows", "specs", "table", "modes", "counts"):
            if run[part] != want[part]:
                fail(f"{label}: the {how} graph run's {part} differ from the "
                     "checked eager run's")
        diff = [k for k, t in want["tensors"].items()
                if not torch.equal(t, run["tensors"][k])]
        if diff:
            fail(f"{label}: the {how} graph run's final reuse cache / decode "
                 f"state differ at {diff[:8]} ({len(diff)} tensors)")
    rows = want["rows"]
    print(f"{label}: both graph runs equal to the checked eager run — "
          f"tokens of {CONTROL_STEPS} steps, {len(rows)} journal rows, final "
          f"specs, policy table ({len(want['table'])} rows), mode mirrors, "
          f"launch counts {want['counts']}, {len(want['tensors'])} tensors of "
          "the final reuse cache and decode state bitwise; every journal "
          "loads and replays")

    # the reference test's properties, as hard checks at full width
    modes = engine.mode_summary(cache)
    ragged = [n for n, s in engine.sites.items() if s.exec_path == "ragged"]
    w0, w1 = win[10].model, win[18].model
    win_mac = (w1["skipped_macs"] - w0["skipped_macs"]) / max(
        w1["total_macs"] - w0["total_macs"], 1e-9)
    ovf = report.model["overflow_fallbacks"]
    decisions = [r for r in rows if r["kind"] == "decision"]
    budget = [r for r in decisions if r["decision_kind"] == "budget"]
    cited = [r for r in budget if "overflow_fallbacks" in r["reason"]]
    print(f"{label}: final modes {modes}; on ragged: {ragged}; converged "
          f"window (steps 11-18) mac_skip {win_mac:.4f}; overflow_fallbacks "
          f"{ovf}; {len(budget)} budget decisions, {len(cited)} citing "
          "overflow_fallbacks")
    missed = [what for what, held in (
        ("a site in reuse mode",
         any(m in ("reuse", "mixed") for m in modes.values())),
        ("a site on the ragged path", bool(ragged)),
        ("converged-window mac_skip above 0.5", win_mac > 0.5),
        ("an overflow fallback", ovf > 0),
        ("a budget decision citing overflow_fallbacks", bool(cited)))
        if not held]
    # the reference's acceptance test for the controller runs qwen3-32b; on
    # rwkv6 the properties are printed: its recurrent state moves the
    # activations of every layer at every step, so the sites below layer
    # 0's first one do not skip on this stream either (PERF.md §6)
    if arch == "qwen3-32b" and missed:
        fail(f"{label}: the acceptance properties missed: {missed}")
    print(f"{label}: acceptance properties of the reference's test "
          + ("all held" if not missed else f"missed: {missed}")
          + ("" if arch == "qwen3-32b" else " (printed, not required: the "
             "reference's test runs qwen3-32b)"))

    by_kind = collections.Counter((r["decision_kind"], r["site"])
                                  for r in decisions)
    for kind in sorted({k for k, _ in by_kind}):
        print(f"  {kind:7s} decisions: " + ", ".join(
            f"{site or '<model>'} {n}" for (k, site), n in
            sorted(by_kind.items()) if k == kind))
    for name, spec in engine.sites.items():
        print(f"  final {name:13s} exec={spec.exec_path:6s} "
              f"block_k={spec.block_k:3d} budget={spec.max_active_k} modes="
              + "".join("R" if m == "reuse" else "b"
                        for m in engine.layer_modes(cache, name)))
    # each capture with the interval before it: what moved the key
    cause = {}
    for r in rows:
        if r["kind"] == "interval":
            cause[r["step"]] = collections.Counter()
            if r["retrace"]:
                cause[r["step"]].update(f"spec:{v}"
                                        for v in r["retrace"].values())
        elif r["decision_kind"] == "mode":
            cause[r["step"]]["mode flips"] += 1
    captured = [i + 1 for i, c in enumerate(log["captured"]) if c]
    print(f"{label}: {summary_line(summ)}")
    budget_only = []
    for i, (sec, pool) in zip(captured, variants):
        why = dict(cause.get(i - 1, {})) if i > 1 else "first step"
        if isinstance(why, dict) and why and set(why) == {"spec:budget"}:
            budget_only.append(i)
        print(f"  capture at step {i:2d} ({why}): {sec:.3f} s, pool "
              f"{pool / 1e6:.1f} MB, step {log['ms'][i - 1]:.2f} ms")
    budget_steps = sorted(s for s, c in cause.items()
                          if set(c) == {"spec:budget"})
    base_steps, base_mb = UNBOUNDED_BASELINE[arch]
    print(f"{label}: against the unbounded baseline ({base_steps} capture "
          f"steps, {base_mb} MB of pools): {summ['decode']} decode "
          f"variants built in {len(captured)} capture steps, "
          f"{summ['evictions']} evictions, {summ['live_decode']} live (cap "
          f"{summ['decode_cap']}), live pools "
          f"{summ['live_pool_bytes'] / 1e6:.1f} MB of "
          f"{summ['pool_bytes'] / 1e6:.1f} MB captured; budget-only "
          f"intervals at steps {budget_steps} captured nothing")
    if budget_only:
        fail(f"{label}: steps {budget_only} captured after intervals whose "
             "only spec move was a budget")
    top = max((pool for _, pool in variants), default=0)
    if summ["live_pool_bytes"] > summ["decode_cap"] * top + prefill_pool:
        fail(f"{label}: live pools {summ['live_pool_bytes']} bytes over the "
             f"cap times the largest decode pool ({top} bytes)")
    if arch == "qwen3-32b" and len(captured) >= base_steps:
        fail(f"{label}: {len(captured)} capture steps, not fewer than the "
             f"unbounded baseline's {base_steps}")
    spans = {}
    for name, a, b in CONTROL_SPANS:
        ts = [log["ms"][i - 1] for i in range(a, b + 1)
              if not log["captured"][i - 1]]
        spans[name] = statistics.median(ts) if ts else None
        print(f"{label}: replay step ms, steps {name}: "
              + (f"median {spans[name]:.2f} over {len(ts)} replays ("
                 + ", ".join(f"{t:.2f}" for t in ts) + ")" if ts else
                 "no replay")
              + " (host clock around synchronize, no profiler)")
    prof = {}
    for i, (_, busy, krows) in sorted(profiles.items()):
        prof[i] = {"busy_ms": busy, "dw_gemm_ms": gemm_ms(krows)}
        print(f"{label}: profiled replay at step {i}: device busy "
              f"{busy:.3f} ms, ΔW GEMMs {prof[i]['dw_gemm_ms']:.3f} ms")
    return {"run": label, "journal_rows": len(rows),
            "decisions": {f"{k}:{s}": n for (k, s), n in by_kind.items()},
            "modes": modes, "ragged": ragged, "win_mac_skip": win_mac,
            "properties_missed": missed,
            "overflow_fallbacks": ovf, "budget_decisions": len(budget),
            "variants": summ["variants"], "captures": summ["captures"],
            "capture_s": summ["capture_s"],
            "pool_mb": summ["pool_bytes"] / 1e6,
            "live_decode": summ["live_decode"], "evictions": summ["evictions"],
            "live_pool_mb": summ["live_pool_bytes"] / 1e6,
            "budget_only_steps": budget_steps,
            "captured_steps": captured, "span_ms": spans,
            "steps_ms": log["ms"], "profiles": prof,
            "launches": dict(want["counts"])}


def control_serve_phase(cfg, argv, drive, logdir, *,
                        label="qwen3 serve --control-every 2", log="phase9b"):
    """Phase 9b (and 11b, with `--latency-table` in `argv`): the serve of
    `argv` (phase 4's) with `--control-every 2 --control-journal`, eagerly
    under the per-call checks (`drive`), then through the graphs. Tokens,
    SensorReport lines, journal rows (without `ts`), the `control plane:`
    line, specs, launch counts and mode mirrors equal, the final reuse cache
    and decode state bitwise. The serves' whole output goes to
    `logdir/<log>_<how>.log`. Returns (the row of the JSON line, the launch
    counts)."""
    from repro_torch.control import load_journal
    from repro_torch.serve.compiled_step import summary_line

    logdir.mkdir(parents=True, exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        for how in ("eager", "graph"):
            print(f"--- {label}: {how} serve")
            gc.collect()
            torch.cuda.empty_cache()
            journal = os.path.join(tmp, f"{how}.jsonl")
            res, counts, text = drive(
                cfg, argv + ["--control-every", "2", "--control-journal",
                             journal] + (["--eager"] if how == "eager" else []),
                check=how == "eager", log_to=logdir / f"{log}_{how}.log")
            eng, rc = res["engine"], res["rcache"]
            served[how] = dict(
                outcome(res, text), counts=counts, specs=dict(eng.sites),
                rows=[{k: v for k, v in r.items() if k != "ts"}
                      for r in load_journal(journal)],
                control=[ln for ln in text.splitlines()
                         if ln.startswith("control plane: ")],
                layer_modes={n: eng.layer_modes(rc, n) for n in eng.sites},
                summary=res["step"].summary())
            del res, eng, rc
    want, got = served["eager"], served["graph"]
    for part in ("tokens", "reports", "modes", "rows", "control", "counts",
                 "specs"):
        if got[part] != want[part]:
            fail(f"{label}: the graph serve's {part} differ from the eager "
                 "serve's")
    diff = [k for k, t in want["tensors"].items()
            if not torch.equal(t, got["tensors"][k])]
    if diff:
        fail(f"{label}: final reuse cache / decode state differ at "
             f"{diff[:8]} ({len(diff)} tensors)")
    if not want["control"]:
        fail(f"{label}: no 'control plane:' line")
    print(f"{label}: graph serve equal to the checked eager serve — tokens, "
          f"{len(want['reports'])} SensorReport lines, {len(want['rows'])} "
          "journal rows, the control plane line, launch counts and "
          f"{len(want['tensors'])} tensors of the final reuse cache and "
          "decode state bitwise")
    print(f"{label}: {want['control'][0]}")
    print(f"{label}: {summary_line(got['summary'])}")
    kinds = collections.Counter(r["decision_kind"] for r in want["rows"]
                                if r["kind"] == "decision")
    print(f"{label}: decisions by kind {dict(kinds)}; final modes per layer "
          "(R reuse, b basic):")
    for name, modes in want["layer_modes"].items():
        spec = want["specs"][name]
        print(f"  {name:9s} " + "".join("R" if m == "reuse" else "b"
                                        for m in modes)
              + f"  exec={spec.exec_path} block_k={spec.block_k}")
    control_serve = {k: want[k] for k in ("control", "layer_modes")}
    control_serve.update(journal_rows=len(want["rows"]),
                         decisions=dict(kinds),
                         variants=got["summary"]["variants"],
                         captures=got["summary"]["captures"],
                         pool_mb=got["summary"]["pool_bytes"] / 1e6)
    return control_serve, want["counts"]


def basic_product_timing(dev, gen) -> dict:
    """The basic-mode product at mlp_in's shape ([8,5120]x[5120,51200]
    bf16): `basic_product` (one bf16 product with an f32 result) against
    the widened `xq.float() @ w.float()` it replaced, checked and timed."""
    from repro_torch.kernels.ops import f32_product as basic_product

    k, n = 5120, 51200
    xq = torch.randn((M, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)
    err = close(basic_product(xq, w), xq.float() @ w.float(), GEMM_ATOL,
                GEMM_RTOL, "basic_product")
    t_new = time_ms(lambda: basic_product(xq, w), iters=10)
    t_old = time_ms(lambda: xq.float() @ w.float(), iters=10)
    byts = k * n * 2 + M * k * 2 + M * n * 4
    bound = max(byts / HBM_BYTES_PER_S, 2 * M * k * n / BF16_FLOPS) * 1e3
    print(f"basic-mode product [{M},{k}]x[{k},{n}] bf16: "
          f"torch.mm(out_dtype=f32) {t_new:.4f} ms, widened xq.float() @ "
          f"w.float() {t_old:.4f} ms (bound {bound:.4f} ms, bytes); max "
          f"|err| {err:.3e}")
    return {"mm_out_dtype": t_new, "widened": t_old, "bound": bound}


def control_loop_phase(cfg, rcfg, dev, max_err) -> dict:
    """Phase 9a on the configs of phases 4 (qwen3 `cfg`) and 6 (rwkv6
    `rcfg`). Prints a JSON line of the runs; returns {run: launch
    counts}."""
    from repro_torch.models import init_params

    out, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, mcfg in (("qwen3-32b", cfg), ("rwkv6-7b", rcfg)):
            gc.collect()
            torch.cuda.empty_cache()
            label = f"{arch} {mcfg.n_layers} layers closed loop"
            print(f"--- {label}")
            params = init_params(mcfg, MEASURED_SEED, device=dev)
            row = control_pair(label, arch, mcfg, params, dev, max_err, tmp)
            row["guard_cost"] = guard_cost(
                f"{arch} {mcfg.n_layers} layers", arch, mcfg, params, dev)
            out.append(row)
            launches[label] = row["launches"]
            del params
    print(json.dumps({"control_loop": out}))
    return launches


# phase 10: the guard plane (repro_torch.guard) on the compiled step. (a) the
# reference's chaos test (tests/test_guard.py::test_chaos_quarantine_e2e_
# bitwise_recovery) at qwen3's mlp_in shape: 8 stacked layers, batch 2, bf16
# weights, integer-valued operands at fixed_scale 1.0, so every f32 sum is
# exact and reuse equals the basic-mode oracle bitwise
CHAOS_LAYERS, CHAOS_BATCH, CHAOS_K, CHAOS_N = 8, 2, 5120, 51200
CHAOS_STEPS, CHAOS_INJECT = 14, 5
# (b) the guarded serve: a NaN into the last layer's mlp_out (it feeds no KV
# cache) after an odd decode step, so the next step reads it and the control
# interval after that one (every 2 steps) sees it
GUARD_INJECT_STEP, GUARD_SITE = 3, "mlp_out"
GUARD_SCENARIOS = (("poison-sim", 3, "sim_range"),
                   ("ctrl-garbage", 3, "ctrl_range"),
                   ("poison-counters", 3, "conservation"),
                   ("stall", 20, "stall_windows"))


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor, so NaNs compare equal to themselves."""
    return t.view({torch.bfloat16: torch.int16, torch.float16: torch.int16,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def chaos_engine(mode: str, dev):
    """The reference test's site at mlp_in's published shape: a permissive
    policy keeps lanes in reuse (the state a poisoned prev_out persists in);
    "auto" runs the masked output-stationary kernel, "basic" the oracle."""
    from repro_torch.core.engine import ReuseEngine
    from repro_torch.core.policy import ReusePolicy, SiteTunables

    eng = ReuseEngine(policy=ReusePolicy(site_tunables={"mlp_in": SiteTunables(
        sim_threshold=0.0, min_work_flops=0.0)}), impl="cuda")
    eng.register("mlp_in", CHAOS_K, CHAOS_N, n_layers=CHAOS_LAYERS,
                 block_m=BM, block_k=BK, mode=mode)
    eng.sites["mlp_in"] = dataclasses.replace(eng.sites["mlp_in"],
                                              fixed_scale=1.0)
    return eng


def chaos_run(dev, w, xs, *, inject: bool, graphs: bool,
              journal: str | None = None) -> dict:
    """The chaos run: the guarded engine and the basic-mode oracle each step
    through a CompiledStep keyed as a decode (captured as CUDA graphs, or
    run directly), poison-nan into layer 0 after step 5, the Controller with
    the breaker every 2 steps (the retuner held off by min_window_steps=100).
    Returns the outputs of both per step and the run's objects."""
    from repro_torch.control import ControlConfig, Controller, DecisionJournal
    from repro_torch.guard import FaultInjector, GuardConfig, QuarantineBreaker
    from repro_torch.serve.compiled_step import CompiledStep

    runs = {}
    for role, mode in (("guarded", "auto"), ("oracle", "basic")):
        eng = chaos_engine(mode, dev)
        cache = eng.init_cache(CHAOS_BATCH, device=dev)
        step = CompiledStep(
            None, None, {"len": torch.zeros((), dtype=torch.int32,
                                            device=dev)},
            batch=CHAOS_BATCH, engine=eng, rcache=cache, graphs=graphs)

        def fn(eng=eng, cache=cache):
            return torch.stack([
                eng.apply("mlp_in", xs[layer], w, None,
                          eng.layer_view(cache, layer)["mlp_in"])[0]
                for layer in range(CHAOS_LAYERS)])
        runs[role] = (eng, cache, step, fn)
    inj = FaultInjector("poison-nan", at_step=CHAOS_INJECT, layer=0) \
        if inject else None
    br = QuarantineBreaker(GuardConfig(quarantine_intervals=1,
                                       probation_windows=1))
    ctl = Controller(ControlConfig(min_window_steps=100), guard=br,
                     journal=DecisionJournal(journal) if journal else None)
    eng, cache = runs["guarded"][:2]
    outs = []
    for t in range(1, CHAOS_STEPS + 1):
        row = []
        for role in ("guarded", "oracle"):
            _, _, step, fn = runs[role]
            # keyed as CompiledStep.decode: the budget lanes synced, the
            # decode key (spec and mode signature) picks the variant
            row.append(step.decode_call(fn).clone())
        outs.append(row)
        if inj is not None:
            inj.on_cache_update(cache, t)
        if t % 2 == 0:
            rep = ctl.step(eng, cache, step=t)
            if rep.changed:
                fail(f"chaos: the interval at step {t} changed a spec")
    torch.cuda.synchronize()
    return {"outs": outs, "eng": eng, "cache": cache, "step": runs[
        "guarded"][2], "ostep": runs["oracle"][2], "br": br, "ctl": ctl,
        "inj": inj}


def chaos_phase(dev, max_err) -> tuple[dict, dict]:
    """Phase 10a: the chaos run eagerly with every kernel call held against
    its plain version, then through CUDA graphs; the graph run equal to the
    eager one bitwise (outputs per step, journal rows, final cache); the
    reference test's properties on both; a run without injection trips
    nothing; the shadow check at the same site. Returns (the row of the
    JSON line, the graph run's launch counts)."""
    from repro_torch.control import load_journal, replay_rows
    from repro_torch.guard import shadow_check
    from repro_torch.kernels import backend, ops
    from repro_torch.serve.compiled_step import summary_line

    label = (f"chaos at mlp_in [{CHAOS_BATCH},{CHAOS_K}]x[{CHAOS_K},"
             f"{CHAOS_N}] bf16, {CHAOS_LAYERS} layers")
    gen = torch.Generator(device=dev).manual_seed(MEASURED_SEED)
    w = torch.randint(-2, 3, (CHAOS_K, CHAOS_N), generator=gen,
                      device=dev).to(torch.bfloat16)
    xs = torch.randint(-3, 4, (CHAOS_LAYERS, CHAOS_BATCH, CHAOS_K),
                       generator=gen, device=dev).to(torch.bfloat16)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for how in ("eager", "graph"):
            backend.reset_launches()
            journal = os.path.join(tmp, f"{how}.jsonl")
            with (PoisonedPathCheck(ops) if how == "eager"
                  else contextlib.nullcontext()) as chk:
                run = chaos_run(dev, w, xs, inject=True,
                                graphs=how == "graph", journal=journal)
            counts = backend.launch_counts()
            if chk is not None:
                if chk.checked != counts:
                    fail(f"{label}: kernel calls checked {chk.checked} != "
                         f"launches {counts}")
                for kn, n in chk.checked.items():
                    if n:
                        max_err[kn] = max(max_err[kn], chk.max_err[kn])
            run["rows"] = [{k: v for k, v in r.items() if k != "ts"}
                           for r in load_journal(journal)]
            run["counts"] = counts
            run["tensors"] = tensor_leaves(run["cache"])
            runs[how] = run
    eager, graph = runs["eager"], runs["graph"]
    for t, (a, b) in enumerate(zip(eager["outs"], graph["outs"]), start=1):
        if not all(bitwise_equal(x, y) for x, y in zip(a, b)):
            fail(f"{label}: step {t}: the graph run's outputs differ from "
                 "the eager run's")
    diff = [k for k, t in eager["tensors"].items()
            if not bitwise_equal(t, graph["tensors"][k])]
    if diff or eager["rows"] != graph["rows"] or \
            eager["counts"] != graph["counts"]:
        fail(f"{label}: the graph run differs from the eager run (cache "
             f"{diff[:6]}, journal rows equal {eager['rows'] == graph['rows']}"
             f", launch counts {graph['counts']} vs {eager['counts']})")
    for name, run in runs.items():
        outs = run["outs"]
        if torch.isfinite(outs[CHAOS_INJECT][0].float()).all():
            fail(f"{label}: {name}: the poisoned lane never reached step "
                 f"{CHAOS_INJECT + 1}'s output")
        for t in range(CHAOS_INJECT + 2, CHAOS_STEPS + 1):
            got, want = outs[t - 1]
            if not torch.isfinite(got.float()).all():
                fail(f"{label}: {name}: step {t} not contained")
            if not bitwise_equal(got, want):
                fail(f"{label}: {name}: step {t} differs from the basic-mode "
                     "oracle")
    rows = graph["rows"]
    chain = [(r["before"], r["after"]) for r in rows
             if r.get("decision_kind") == "quarantine"
             and r.get("field") == "state" and r.get("layer") == 0]
    if chain != [("active", "quarantined"), ("quarantined", "probation"),
                 ("probation", "active")]:
        fail(f"{label}: the journal chains {chain}")
    if not replay_rows(rows).ok:
        fail(f"{label}: the journal does not replay")
    eng, cache, br = graph["eng"], graph["cache"], graph["br"]
    if br.lane_states().get(("mlp_in", 0)) != "active" or \
            eng.layer_modes(cache, "mlp_in")[0] != "reuse" or \
            int(cache["mlp_in"]["ctrl"]["quarantine"].max()) != 0:
        fail(f"{label}: the lane was not re-admitted to reuse")
    summ = graph["step"].summary()
    print(f"{label}: eager (every kernel call checked) and CUDA-graph runs "
          f"bitwise equal over {CHAOS_STEPS} steps, journal rows "
          f"({len(rows)}) and the final cache; the NaN reached step "
          f"{CHAOS_INJECT + 1}, steps {CHAOS_INJECT + 2}-{CHAOS_STEPS} finite "
          "and bitwise the basic-mode oracle; journal chain "
          f"{' -> '.join(['active'] + [b for _, b in chain])}, replays; "
          f"{br.total_trips} trip(s); launches {dict(graph['counts'])}")
    print(f"{label}: guarded step: {summary_line(summ)}")
    counts = dict(graph["counts"])
    del runs, eager, graph
    clean = chaos_run(dev, w, xs, inject=False, graphs=True)
    quarantines = [d for r in clean["ctl"].reports for d in r.decisions
                   if d.kind == "quarantine"]
    if clean["br"].total_trips or quarantines:
        fail(f"{label}: the run without injection tripped "
             f"{clean['br'].total_trips} time(s)")
    print(f"{label}: the same run without injection: 0 trips, 0 quarantine "
          "decisions")
    ok, detail = shadow_check(clean["eng"], "mlp_in")
    print(f"{label}: shadow check of the live operating point on the card: "
          f"{detail}")
    if not ok:
        fail(f"{label}: shadow check: {detail}")
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    return ({"run": label, "journal_rows": len(rows), "trips": br.total_trips,
             "chain": chain, "captures": summ["captures"],
             "pool_mb": summ["pool_bytes"] / 1e6, "shadow": detail},
            counts)


@contextlib.contextmanager
def recorded_finite():
    """Per decode of the run inside it, whether each slot's logits are all
    finite (kept on the card), from the logits `CompiledStep.decode`
    returns."""
    from repro_torch.serve.compiled_step import CompiledStep

    orig = CompiledStep.decode
    rec = []

    def decode(self, tokens):
        out = orig(self, tokens)
        rec.append(torch.isfinite(out).flatten(1).all(1))
        return out

    CompiledStep.decode = decode
    try:
        yield rec
    finally:
        CompiledStep.decode = orig


def guard_serve_phase(cfg, argv, drive, logdir) -> tuple[dict, dict]:
    """Phase 10b: `serve.run` on `cfg` with `--control-every 2
    --control-journal J --inject poison-nan` into the last layer's mlp_out,
    eagerly with every kernel call checked, then through the graphs: equal
    tokens, journal rows, SensorReport lines and final cache and state
    (bitwise); the trip in the first interval after the injection, with
    check nonfinite_out; logits non-finite at the next step for the
    poisoned slot and finite from the step after the trip; the journal
    replays through the CLI; the serve without --inject trips nothing. Then
    each other cache scenario and the stall through the graph serve cut to
    2 layers, each tripping its own check. Returns (the row of the JSON
    line, {run: launch counts})."""
    from repro_torch.control import load_journal
    from repro_torch.control import replay as replay_cli
    from repro_torch.serve.compiled_step import summary_line

    logdir.mkdir(parents=True, exist_ok=True)
    layer = cfg.n_layers - 1
    spec = f"poison-nan:at_step={GUARD_INJECT_STEP},site={GUARD_SITE}," \
           f"layer={layer}"
    label = f"qwen3 guarded serve --inject {spec}"
    trip_step = GUARD_INJECT_STEP + 1  # the first interval after it
    served, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for how in ("eager", "graph", "clean"):
            print(f"--- {label}: {how} serve")
            gc.collect()
            torch.cuda.empty_cache()
            journal = os.path.join(tmp, f"{how}.jsonl")
            run_argv = argv + ["--control-every", "2", "--control-journal",
                               journal]
            if how != "clean":
                run_argv += ["--inject", spec]
            if how == "eager":
                run_argv += ["--eager"]
            with recorded_finite() as finite:
                res, counts, text = drive(
                    cfg, run_argv, check=how == "eager",
                    log_to=logdir / f"phase10b_{how}.log",
                    checker=PoisonedPathCheck)
            launches[f"guarded serve ({how})"] = counts
            rows = load_journal(journal)
            served[how] = dict(
                outcome(res, text), counts=counts,
                rows=[{k: v for k, v in r.items() if k != "ts"}
                      for r in rows],
                finite=torch.stack(finite).cpu().tolist(),
                guard=[ln for ln in text.splitlines()
                       if ln.startswith("guard plane:")],
                trips=res["breaker"].total_trips,
                summary=res["step"].summary(),
                slot0=[(r.rid, len(r.output)) for r in res["done"]
                       if r.slot == 0])
            if how == "graph":
                rc = replay_cli.main([journal])
                if rc != 0:
                    fail(f"{label}: `replay {journal}` returned {rc}")
            del res
    want, got = served["eager"], served["graph"]
    for part in ("tokens", "reports", "modes", "rows", "counts", "finite",
                 "guard"):
        if got[part] != want[part]:
            fail(f"{label}: the graph serve's {part} differ from the eager "
                 "serve's")
    diff = [k for k, t in want["tensors"].items()
            if not bitwise_equal(t, got["tensors"][k])]
    if diff:
        fail(f"{label}: final reuse cache / decode state differ at "
             f"{diff[:8]} ({len(diff)} tensors)")
    trips = [r for r in got["rows"] if r.get("decision_kind") == "quarantine"
             and r.get("field") == "state" and r["after"] == "quarantined"]
    if [(r["step"], r["site"], r["layer"]) for r in trips] != [
            (trip_step, GUARD_SITE, layer)] or \
            not trips[0]["reason"].startswith("nonfinite_out:"):
        fail(f"{label}: trips {[(r['step'], r['site'], r['layer'], r['reason']) for r in trips]}"
             f", want one nonfinite_out at step {trip_step} on "
             f"{GUARD_SITE}@{layer}")
    finite = got["finite"]
    poisoned = finite[trip_step - 1]
    if all(poisoned) or not all(all(f) for f in finite[trip_step:]) or \
            not all(all(f) for f in finite[:trip_step - 1]):
        fail(f"{label}: logits finite per step and slot {finite}: want "
             f"non-finite only at step {trip_step}")
    clean = served["clean"]
    qrows = [r for r in clean["rows"]
             if r.get("decision_kind") == "quarantine"]
    if clean["trips"] or qrows:
        fail(f"{label}: the serve without --inject tripped "
             f"{clean['trips']} time(s), {len(qrows)} quarantine rows")
    slots = [i for i, ok in enumerate(poisoned) if not ok]
    print(f"{label}: traffic: phase 4's (8 requests of 32-token random "
          f"prompts, batch 8, {len(finite)} decode steps); slot 0 holds "
          f"(rid, tokens) {got['slot0']}, live at the interval of step "
          f"{trip_step}")
    print(f"{label}: graph serve equal to the checked eager serve — tokens, "
          f"{len(want['reports'])} SensorReport lines, {len(want['rows'])} "
          f"journal rows, launch counts and {len(want['tensors'])} tensors of "
          "the final reuse cache and decode state bitwise")
    print(f"{label}: trip at step {trip_step} ({trips[0]['reason']}); logits "
          f"non-finite at step {trip_step} for slots {slots}, finite at every "
          f"other step; replay OK; {got['guard'][0]}")
    print(f"{label}: {summary_line(got['summary'])}")
    print(f"{label}: the serve without --inject: 0 trips, 0 quarantine rows; "
          f"{clean['guard'][0]}")
    out = {"serve": label, "trip_step": trip_step,
           "trip_reason": trips[0]["reason"], "slots_poisoned": slots,
           "journal_rows": len(want["rows"]),
           "captures": got["summary"]["captures"],
           "evictions": got["summary"]["evictions"],
           "pool_mb": got["summary"]["pool_bytes"] / 1e6,
           "live_pool_mb": got["summary"]["live_pool_bytes"] / 1e6,
           "scenarios": []}
    del served, want, got

    # each other scenario once, through the graph serve cut to 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    with tempfile.TemporaryDirectory() as tmp:
        for scen, at, check in GUARD_SCENARIOS:
            gc.collect()
            torch.cuda.empty_cache()
            journal = os.path.join(tmp, f"{scen}.jsonl")
            # the stall needs 8 replayed steps before it for the watchdog's
            # median (a later --max-new wins)
            run_argv = argv + ["--max-new", "24"] * (scen == "stall") + [
                "--control-every", "2", "--control-journal", journal,
                "--inject", f"{scen}:at_step={at}"]
            print(f"--- qwen3 2 layers, graph serve --inject "
                  f"{scen}:at_step={at}")
            res, counts, text = drive(cfg2, run_argv, check=False,
                                      log_to=logdir / f"phase10b_{scen}.log")
            launches[f"--inject {scen} (2 layers)"] = counts
            rows = load_journal(journal)
            if check == "stall_windows":
                hit = [r for r in rows if r.get("field") == "stall_windows"
                       and f"step {at} took" in r["reason"]]
            else:
                hit = [r for r in rows if r.get("decision_kind") ==
                       "quarantine" and r.get("field") == "state"
                       and r["after"] == "quarantined"
                       and r["reason"].startswith(f"{check}:")]
            summ = res["step"].summary()
            if not hit or not res["injector"].fired:
                fail(f"--inject {scen}: no {check} row in the journal "
                     f"(fired {res['injector'].fired})")
            print(f"--inject {scen}: {check} at step {hit[0]['step']} "
                  f"({hit[0]['reason'][:100]}); {summary_line(summ)}")
            out["scenarios"].append({
                "scenario": scen, "check": check, "step": hit[0]["step"],
                "captures": summ["captures"], "evictions": summ["evictions"],
                "pool_mb": summ["pool_bytes"] / 1e6,
                "live_pool_mb": summ["live_pool_bytes"] / 1e6})
            del res
    return out, launches


def interval_cost_phase(cfg, argv, drive, logdir) -> dict:
    """Phase 10c: the sentinel lanes' cost end to end. The graph serves of
    `argv` (phase 4's traffic, 24 new tokens: 23 decode steps) with
    `--refresh-every 2` and with `--control-every 2` (the breaker on), each
    with the lanes in the breaker's snapshot alone (the engine as it is)
    and forced into every ctrl snapshot, in turns (as is, forced, forced,
    as is). Prints the serve's `decode loop:` ms a token (each replayed
    step's decode plus the host work after it) and the hooks' total ms."""
    from repro_torch.core.engine import ReuseEngine

    plain = ReuseEngine.ctrl_snapshot

    def every_snapshot(self, cache, *, sentinels=False):
        return plain(self, cache, sentinels=True)

    argv = argv + ["--max-new", "24"]  # a later --max-new wins
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (
                ("--refresh-every 2", ["--refresh-every", "2"]),
                ("--control-every 2", ["--control-every", "2"])):
            rows = {"breaker only": [], "every snapshot": []}
            for n, how in enumerate(("breaker only", "every snapshot",
                                     "every snapshot", "breaker only")):
                gc.collect()
                torch.cuda.empty_cache()
                run_argv = argv + extra
                if label.startswith("--control"):
                    run_argv += ["--control-journal",
                                 os.path.join(tmp, f"{n}.jsonl")]
                if how == "every snapshot":
                    ReuseEngine.ctrl_snapshot = every_snapshot
                try:
                    res, _, _ = drive(
                        cfg, run_argv, check=False,
                        log_to=logdir / f"phase10c_{label[2:9]}_{n}.log")
                finally:
                    ReuseEngine.ctrl_snapshot = plain
                if res["loop_ms_per_token"] is None:
                    fail(f"interval cost {label}: no step replayed")
                rows[how].append({"ms_a_token": res["loop_ms_per_token"],
                                  "hooks_ms": sum(res["hook_ms"])})
                del res
            for how, rs in rows.items():
                print(f"interval cost, qwen3 graph serve {label}, sentinel "
                      f"lanes in {how}: decode loop "
                      + ", ".join(f"{r['ms_a_token']:.4f}" for r in rs)
                      + " ms a token; hooks "
                      + ", ".join(f"{r['hooks_ms']:.2f}" for r in rs)
                      + " ms in all")
            out[label] = rows
    return out


def guard_cost(label, arch, cfg, params, dev) -> dict:
    """What the guard adds to one Controller.step with a window on every
    site: its device→host copies (torch.profiler's Memcpy DtoH), with and
    without the breaker; and the host ms of `ctrl_snapshot` with the
    sentinel lanes (the breaker's) and without them (a mode refresh's),
    in turns (host clock around the call, which waits for its copy)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.control import ControlConfig, Controller
    from repro_torch.guard import QuarantineBreaker
    from repro_torch.sensor.runner import run_measured_decode

    copies, snap_ms, lane_ms = {}, [], []
    for guarded in (False, True):
        ctl = Controller(ControlConfig(min_window_steps=2),
                         guard=QuarantineBreaker() if guarded else None)

        def on_step(i, engine, cache, ctl=ctl, guarded=guarded):
            if i == 2:
                ctl.step(engine, cache, step=i)
            elif i == 4:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    rep = ctl.step(engine, cache, step=i)
                    torch.cuda.synchronize()
                copies[guarded] = sum(1 for e in prof.events()
                                      if "Memcpy DtoH" in e.name)
                if len(rep.window_steps) != len(engine.sites):
                    fail(f"{label}: the profiled interval has windows on "
                         f"{len(rep.window_steps)} of {len(engine.sites)} "
                         "sites")
                if guarded:
                    for _ in range(10):
                        for sentinels, times in ((True, lane_ms),
                                                 (False, snap_ms)):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            engine.ctrl_snapshot(cache, sentinels=sentinels)
                            times.append((time.perf_counter() - t0) * 1e3)

        run_measured_decode(arch, steps=4, batch=CONTROL_BATCH,
                            correlation=1.0, seed=MEASURED_SEED,
                            on_step=on_step, device=dev, params=params,
                            cfg=cfg, graphs=False)
    med, lanes = statistics.median(snap_ms), statistics.median(lane_ms)
    print(f"{label}: one Controller.step with a window on every site: "
          f"{copies[False]} device->host copies without the guard, "
          f"{copies[True]} with the QuarantineBreaker; ctrl_snapshot median "
          f"host time with the sentinel lanes (the breaker's) {lanes:.3f} ms "
          "(10 calls: " + ", ".join(f"{t:.3f}" for t in lane_ms) + "), "
          f"without them (a mode refresh's) {med:.3f} ms ("
          + ", ".join(f"{t:.3f}" for t in snap_ms) + "), in turns")
    if copies[True] != copies[False] + 1:
        fail(f"{label}: the guard adds {copies[True] - copies[False]} "
             "device->host copies, not 1 (its snapshot)")
    return {"copies": copies[False], "copies_guarded": copies[True],
            "ctrl_snapshot_ms": med, "ctrl_snapshot_ms_all": snap_ms,
            "ctrl_snapshot_sentinels_ms": lanes,
            "ctrl_snapshot_sentinels_ms_all": lane_ms}


# phase 11: the observability plane on the compiled serve. (a) phase 4's
# serve with --obs-dir: spans, metrics and the latency table probed through
# CUDA graphs of each path, then the probe run eagerly under the per-call
# checks, its caches bitwise the graph probe's; (b) phase 4's serve with
# --control-every 2 --latency-table (a's table), eager-checked then graphs;
# (c) --profile-dir; (d) the replica harness, clean and with poison-sim on r1
# (one wave of 2 requests on the 2 slots of each replica), and the clean
# fleet whose second wave starts at a control interval (a diagnostic)
FLEET_ARGV = ["--arch", "qwen3-32b", "--replicas", "2", "--requests", "2",
              "--max-new", "32", "--control-every", "4", "--traffic",
              "repeat"]
FLEET_INJECT = "poison-sim:at_step=24"
FLEET_BOUNDARY = ["--requests", "4", "--max-new", "16"]
# the kernels of a profile by the name of their instance (the three float
# ΔW GEMMs are instances of one tile loop, `cluster_gemm<T, List>`)
TRACE_NAMES = {"delta_quant": "delta_quant", "reuse_matmul_output": "MaskList",
               "reuse_matmul_input": "InputList",
               "reuse_matmul_ragged": "RaggedList"}
OBS_ITERS = 5  # the timed calls a path of `probe_latency_table`


def probe_device_ms(spans) -> dict:
    """{(site, path): median device ms} of the probe's `site_probe` spans
    (CUDA events around each timed call)."""
    by = collections.defaultdict(list)
    for r in spans:
        if r["name"] == "site_probe":
            by[(r["site"], r["exec_path"])].append(
                r.get("device_s", math.nan) * 1e3)
    return {k: statistics.median(v) for k, v in by.items()}


def obs_serve_phase(cfg, argv, drive, dev, max_err, results, logdir):
    """Phase 11a: the graph serve of `argv` with `--obs-dir` (the table
    probed through CUDA graphs, its call recorded: caches, skip rates,
    launches), every file checked; then the same probe run directly under
    the per-call checks, caches bitwise equal. Returns (the row of the
    JSON line, {run: launch counts}, the table's path)."""
    from repro_torch.kernels import backend, ops
    from repro_torch.kernels.reuse_matmul import reuse_matmul
    from repro_torch.obs import latency as lat_mod
    from repro_torch.obs.export import load_snapshots, parse_prometheus

    label = "qwen3 serve --obs-dir"
    d = logdir / "phase11a_obs"
    shutil.rmtree(d, ignore_errors=True)
    orig, seen = lat_mod.probe_latency_table, {}

    def recording(engine, batch, **kw):
        kw["caches"] = seen["caches"] = {}
        seen.update(skips=dict(kw["skip_rates"]), graphs=kw["graphs"],
                    batch=batch)
        torch.cuda.synchronize()
        before, t0 = backend.launch_counts(), time.perf_counter()
        table = orig(engine, batch, **kw)
        torch.cuda.synchronize()
        seen["seconds"] = time.perf_counter() - t0
        after = backend.launch_counts()
        seen["launches"] = {k: after[k] - before[k] for k in after}
        return table

    print(f"--- {label}: graph serve, then its probe")
    lat_mod.probe_latency_table = recording
    try:
        res, counts, text = drive(cfg, argv + ["--obs-dir", str(d)],
                                  check=False,
                                  log_to=logdir / "phase11a_graph.log")
    finally:
        lat_mod.probe_latency_table = orig
    if not seen["graphs"]:
        fail(f"{label}: the probe ran without CUDA graphs")
    engine, steps = res["engine"], res["stats"]["steps"]
    table = lat_mod.load_latency_table(str(d / "latency_table.json"))
    prov = lat_mod.table_provenance(table)
    want = {}
    for name, spec in engine.sites.items():
        gk = -(-spec.in_features // spec.block_k)
        want[name] = {"basic", "kernel"} | ({"ragged"} if gk >= 2 else set())
        got = table.paths_for(name)
        if set(got) != want[name] or \
                any(st.count != OBS_ITERS for st in got.values()):
            fail(f"{label}: table covers {name} with "
                 f"{ {p: st.count for p, st in got.items()} }, want "
                 f"{sorted(want[name])} x {OBS_ITERS}")
    if prov != "compiled":
        fail(f"{label}: table provenance {prov!r}, not 'compiled'")
    prom = parse_prometheus((d / "metrics.prom").read_text())
    snaps = load_snapshots(str(d / "metrics.jsonl"))
    spans = [json.loads(ln) for ln in open(d / "spans.jsonl")]
    n_step = sum(r["name"] == "serve_step" for r in spans)
    n_prefill = sum(r["name"] == "prefill" for r in spans)
    if n_step != steps or prom["span_serve_step_seconds_count"][""] != steps:
        fail(f"{label}: {n_step} serve_step spans for {steps} decode steps")
    if n_prefill != len(res["done"]) or not snaps:
        fail(f"{label}: {n_prefill} prefill spans, {len(snaps)} snapshots")
    dev_ms = probe_device_ms(spans)
    print(f"{label}: {len(table)} table rows, provenance {prov}; "
          f"{n_step} serve_step spans for {steps} steps, {n_prefill} "
          f"prefill spans, metrics.prom {sum(map(len, prom.values()))} "
          f"samples, {len(snaps)} snapshot(s); probe "
          f"{seen['seconds']:.2f} s at skips "
          + ", ".join(f"{s} {v:.3f}" for s, v in seen["skips"].items()))
    print(f"{label}: probed per site and path (f32 weights, batch "
          f"{seen['batch']}; host p50 of {OBS_ITERS} calls around a "
          "synchronize, and the median device ms between CUDA events):")
    rows = []
    for r in table.rows():
        key = (r["site"], r["exec_path"])
        print(f"  {r['site']:9s} {r['exec_path']:7s} p50 "
              f"{r['p50_s'] * 1e3:8.4f} ms  device {dev_ms[key]:8.4f} ms")
        rows.append({"site": r["site"], "path": r["exec_path"],
                     "p50_ms": r["p50_s"] * 1e3, "device_ms": dev_ms[key]})
    serve_counts = {k: counts[k] - seen["launches"][k] for k in counts}
    graph_caches, graph_launches = seen["caches"], seen["launches"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # the same probe, run directly, every kernel call held against its
    # plain version; the caches it leaves must equal the graph probe's
    print(f"--- {label}: the probe run directly, under the per-call checks")
    backend.reset_launches()
    eager_caches = {}
    with PathCheck(ops) as chk:
        lat_mod.probe_latency_table(engine, seen["batch"],
                                    skip_rates=seen["skips"], device=dev,
                                    graphs=False, caches=eager_caches)
    torch.cuda.synchronize()
    eager_launches = backend.launch_counts()
    if chk.checked != eager_launches:
        fail(f"{label}: probe kernel calls checked {chk.checked} != "
             f"launches {eager_launches}")
    if eager_launches != graph_launches:
        fail(f"{label}: eager probe launches {eager_launches} != graph "
             f"probe {graph_launches}")
    for kn, n in chk.checked.items():
        if n:
            max_err[kn] = max(max_err[kn], chk.max_err[kn])
    if eager_caches.keys() != graph_caches.keys():
        fail(f"{label}: probed paths differ between the runs")
    diff = [(key, leaf) for key, c in eager_caches.items()
            for leaf, t in tensor_leaves(c).items()
            if not bitwise_equal(t, tensor_leaves(graph_caches[key])[leaf])]
    if diff:
        fail(f"{label}: eager and graph probe caches differ at {diff[:6]}")
    print(f"{label}: eager probe: every kernel call held against its plain "
          "version (max err " + ", ".join(
              f"{kn} {chk.max_err[kn]:.3e}"
              for kn, n in chk.checked.items() if n)
          + f"); launches {eager_launches} equal the graph probe's; the "
          f"{len(eager_caches)} final site caches bitwise the graph probe's")

    # the probe's weights are f32, the serve's bf16: mlp_in's kernel path
    # beside phase 3's bf16 kernel at the same shape, and the f32 kernel
    k, n = (engine.sites["mlp_in"].in_features,
            engine.sites["mlp_in"].out_features)
    gen = torch.Generator(device=dev).manual_seed(11)
    delta, w, prev, mask = gemm_operands(M, k, n, 0.0, torch.float32, gen,
                                         dev)
    f32_ms = time_ms(lambda: reuse_matmul(
        delta, w, prev, mask, block_m=BM, block_n=BN, block_k=BK,
        dataflow="output"))
    bf16_ms = results["reuse_matmul_output"]["by_shape"][
        f"mlp_in [{M},{k}]x[{k},{n}] skip 0.0"]["ms"]
    p50 = table.stat("mlp_in", "kernel").p50_s * 1e3
    print(f"{label}: mlp_in [{M},{k}]x[{k},{n}]: the probe's kernel path "
          f"(f32 weights, the whole reuse_linear call) p50 {p50:.4f} ms, "
          f"device {dev_ms[('mlp_in', 'kernel')]:.4f} ms; the f32 "
          f"output-stationary kernel alone {f32_ms:.4f} ms; phase 3's bf16 "
          f"kernel {bf16_ms:.4f} ms ({f32_ms / bf16_ms:.2f}x)")
    del delta, w, prev, mask, eager_caches, graph_caches, engine
    gc.collect()
    torch.cuda.empty_cache()
    row = {"rows": rows, "probe_s": seen["seconds"], "skips": seen["skips"],
           "serve_steps": steps, "mlp_in_f32_kernel_ms": f32_ms,
           "mlp_in_bf16_kernel_ms": bf16_ms}
    launches = {"obs serve (graph)": serve_counts,
                "probe (graph)": graph_launches,
                "probe (eager, checked)": eager_launches}
    return row, launches, d / "latency_table.json"


def profile_phase(cfg, argv, drive, logdir) -> dict:
    """Phase 11c: the graph serve with `--obs --profile-dir`: the Chrome
    trace must exist, hold one `serve_step` range per decode step, and
    name each of the port's kernels as often as the run launched it (the
    replays' kernels included); prints what else it holds."""
    label = "qwen3 serve --obs --profile-dir"
    with tempfile.TemporaryDirectory() as tmp:
        print(f"--- {label}: graph serve")
        res, counts, text = drive(cfg, argv + ["--obs", "--profile-dir", tmp],
                                  check=False,
                                  log_to=logdir / "phase11c_graph.log")
        path = pathlib.Path(tmp) / "trace.json"
        if res["profile"] != str(path) or not path.exists():
            fail(f"{label}: no Chrome trace at {path}")
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    steps = res["stats"]["steps"]
    cats = collections.Counter(e.get("cat", "?") for e in events)
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "kernel")
    n_step = sum(e.get("name") == "serve_step" and
                 e.get("cat") == "user_annotation" for e in events)
    n_graph = sum("GraphLaunch" in e.get("name", "") for e in events)
    print(f"{label}: trace {size / 1e6:.1f} MB, {len(events)} events by "
          f"category {dict(cats.most_common(8))}; {n_step} serve_step ranges "
          f"for {steps} decode steps; {n_graph} graph-launch calls; "
          f"{sum(names.values())} kernel events, {len(names)} names")
    for kname, c in names.most_common(8):
        print(f"    {c:6d}x  {kname[:100]}")
    ours = {kn: sum(c for nm, c in names.items() if key in nm)
            for kn, key in TRACE_NAMES.items()}
    print(f"{label}: the port's kernels in the trace by name: {ours}; "
          f"launched in the run: { {kn: counts[kn] for kn in ours} }")
    if n_step != steps:
        fail(f"{label}: {n_step} serve_step ranges in the trace for {steps} "
             "decode steps")
    if any(ours[kn] != counts[kn] for kn in ours):
        fail(f"{label}: the trace names the port's kernels {ours} times, "
             "not as often as the run launched them")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"trace_mb": size / 1e6, "events": len(events),
            "categories": dict(cats), "serve_step_ranges": n_step,
            "graph_launches": n_graph, "kernel_events": sum(names.values()),
            "port_kernels": ours}


def fleet_phase(cfg, logdir) -> tuple[dict, dict]:
    """Phase 11d: `replicas.run` with 2 replicas on repeat traffic, clean
    and with poison-sim armed on r1: no alert on the clean fleet, alerts
    naming r1 alone on the injected one; the fleet report has 2 replicas;
    `python -m repro_torch.obs.top --fleet <out> --once` renders it. Then,
    as a diagnostic with no gate, the clean fleet whose second wave of
    requests starts at a control interval (`FLEET_BOUNDARY`): its alerts
    are printed. Returns (the row of the JSON line, {run: launch
    counts})."""
    from repro_torch.kernels import backend
    from repro_torch.launch import replicas

    row, launches = {}, {}
    for how, extra in (("clean", []), ("inject", ["--inject", FLEET_INJECT]),
                       ("boundary", FLEET_BOUNDARY)):
        label = f"fleet of 2 ({how})"
        out = logdir / f"phase11d_{how}"
        shutil.rmtree(out, ignore_errors=True)
        args = replicas.build_parser().parse_args(
            FLEET_ARGV + extra + ["--out", str(out)])
        print(f"--- {label}: replicas.run {' '.join(FLEET_ARGV + extra)}")
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        backend.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = replicas.run(cfg, args)
        torch.cuda.synchronize()
        launches[f"fleet ({how})"] = backend.launch_counts()
        text = buf.getvalue()
        (logdir / f"phase11d_{how}.log").write_text(text)
        for ln in text.splitlines():
            if ln.startswith(("SLO alert", "FleetReport", "  replica",
                              "fleet", "[r0] run", "[r1] run")) or \
                    "inject" in ln:
                print(f"  {ln}")
        alerts = [(a["alert_kind"], a["replica"], a["site"])
                  for a in res["alerts"]]
        with open(out / "fleet_report.json") as f:
            rep = json.load(f)
        if rep["n_replicas"] != 2:
            fail(f"{label}: fleet report has {rep['n_replicas']} replicas")
        if how == "clean" and alerts:
            fail(f"{label}: alerts on the clean fleet: {alerts}")
        if how == "boundary":
            print(f"{label}: diagnostic, no gate: {len(alerts)} alerts "
                  f"{alerts}")
        if how == "inject" and (not alerts or
                                {r for _, r, _ in alerts} != {"r1"}):
            fail(f"{label}: alerts {alerts}, want alerts naming r1 alone")
        reps = {}
        for r in res["replicas"]:
            s = r.step.summary()
            tokens = r.batcher.stats["emitted_tokens"]
            reps[r.name] = {
                "tokens": tokens, "turn_s": r.turn_s,
                "tokens_per_s": tokens / r.turn_s,
                "variants": s["variants"], "decode_variants": s["decode"],
                "evictions": s["evictions"],
                "live_pool_mb": s["live_pool_bytes"] / 1e6,
                "pool_mb": s["pool_bytes"] / 1e6,
                "trips": r.breaker.total_trips}
            print(f"{label}: {r.name}: {tokens} tokens in {r.turn_s:.2f} s "
                  f"of its turns ({tokens / r.turn_s:.1f} tokens/s); "
                  f"{s['variants']} variants built ({s['decode']} decode), "
                  f"{s['evictions']} evictions, live pools "
                  f"{s['live_pool_bytes'] / 1e6:.1f} MB (captured "
                  f"{s['pool_bytes'] / 1e6:.1f} MB)")
        top = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.top", "--fleet",
             str(out), "--once"], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(pathlib.Path(
                __file__).resolve().parent / "src")))
        if top.returncode != 0 or "(2 replicas)" not in top.stdout:
            fail(f"{label}: obs.top --fleet returned {top.returncode}: "
                 f"{top.stderr[-500:]}")
        print(f"{label}: python -m repro_torch.obs.top --fleet {out.name} "
              "--once:")
        print("\n".join(f"    {ln}" for ln in top.stdout.splitlines()))
        row[how] = {"alerts": alerts, "seconds": res["seconds"],
                    "replicas": reps,
                    "fleet_mac_skip": rep["fleet"]["mac_skip_rate"]}
        del res
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches


# phase 12: the MoE family on the compiled serve (mixtral-8x7b and
# llama4-scout-17b-a16e at published widths, cut in depth), the sliding-window
# rolling KV cache, per-(slot, expert) expert reuse, and the compact exec
# path with the reference serve's jnp tier
MOE_LAYERS = {"mixtral-8x7b": 4, "llama4-scout-17b-a16e": 2}
MOE_CORRELATION, MOE_STEPS = 0.9, 12      # the runner's mixtral point
WINDOW_PROMPT, WINDOW_STEPS = 4088, 16
# 12b: a slot that holds the right position differs from the windowed
# prefill's by bf16 roundings summed in another order (the prefill's and the
# decode's products, attention and expert buffers differ in shape); a slot
# that holds another position differs by the values themselves, a relative
# L2 error near sqrt(2)
WINDOW_RTOL = 5e-2
# a token whose top-2 gates tie within those roundings may take another
# expert in one run than in the other. It is excused only where the runs'
# routing is its own logits' top-k (the router-logit gap between its k-th
# and (k+1)-th expert is >= -WINDOW_GAP_EPS in each run: f32 softmax may
# round two nearly equal logits to one gate), that gap in each run is no
# larger than twice the largest move of its logits between the runs, and
# its h (the router's input) moved by no more than WINDOW_RTOL relative:
# bf16 roundings, not another input
WINDOW_GAP_EPS = 1e-5
COMPACT_STEPS, COMPACT_BATCH = 24, 2
COMPACT_SITES = ("attn_qkv", "mlp_in")
EXPERT_REUSE_B, EXPERT_REUSE_STEPS = 8, 8
# 12e: codes that land within f32 rounding of an int8 boundary may round
# the other way in the oracle; at most this share of the activation codes
ACT_FLIP_SHARE = 1e-3


def moe_cfg(name: str, **changes):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=MOE_LAYERS[name],
                               **changes)


def expert_bytes(cfg) -> int:
    """Bytes of the routed experts' weights a decode step reads: every
    expert of every layer (the capacity buffer has a row for each)."""
    d, f = cfg.d_model, cfg.d_ff
    return cfg.n_layers * cfg.n_experts * 3 * d * f * 2


def moe_serve_phase(serve_pair, graph_rows) -> dict:
    """12a and 12c: phase 4's traffic with --reuse on full-width mixtral-8x7b
    (4 of 32 layers) and llama4-scout-17b-a16e (2 of 48): the checked eager
    serve, then the graph serve, held equal. Returns {serve: launches}."""
    launches = {}
    for name, label in (("mixtral-8x7b", "mixtral serve"),
                        ("llama4-scout-17b-a16e", "llama4 serve")):
        cfg = moe_cfg(name)
        argv = ["--arch", name, "--reuse", "--batch-slots", "8",
                "--requests", "8", "--prompt-len", "32", "--cache-len",
                "128", "--max-new", "8"]
        gc.collect()
        torch.cuda.empty_cache()
        counts, _ = serve_pair(cfg, argv, label, pairs=3)
        launches[f"{label} (eager, checked)"] = counts
        for kn in ("delta_quant", "reuse_matmul_output"):
            if counts[kn] <= 0:
                fail(f"{kn} was not launched on the {label} path")
        eb = expert_bytes(cfg)
        row = graph_rows[-1]
        print(f"{label}: the routed experts' weights a decode step reads: "
              f"{eb / 1e9:.3f} GB ({cfg.n_layers} layers x "
              f"{cfg.n_experts} experts), bound {eb / HBM_BYTES_PER_S * 1e3:.3f}"
              f" ms at 3.35 TB/s; one replay busy {row['busy_graph_ms']:.2f} "
              f"ms, replay median {row['graph_ms']:.2f} ms")
        row["expert_bytes"] = eb
        row["expert_bound_ms"] = eb / HBM_BYTES_PER_S * 1e3
    return launches


def moe_runner_phase(params, cfg, dev, max_err) -> tuple[dict, dict]:
    """12a's runner: run_measured_decode at mixtral's operating point
    (correlation 0.9), batch 8, eager-checked then twice as graphs."""
    label = f"mixtral b8 measured ({MOE_CORRELATION})"
    print(f"--- {label}")
    md, counts, log = measured_pair(
        label, "mixtral-8x7b", cfg, params, steps=MOE_STEPS, batch=8,
        policy=lambda: None, dev=dev, max_err=max_err,
        correlation=MOE_CORRELATION)
    row = measured_summary(label, md, counts, log,
                           correlation=MOE_CORRELATION)
    del md
    return row, {label: counts}


def route_gap(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """[T]: the least router logit of each token's chosen experts less the
    largest of the others (>= 0 where the choice is the logits' top-k)."""
    inside = torch.zeros_like(logits, dtype=torch.bool).scatter_(
        1, chosen, True)
    return (logits.masked_fill(~inside, math.inf).amin(-1)
            - logits.masked_fill(inside, -math.inf).amax(-1))


def tie_readings(dec_e, pre_e, dec_h, pre_h, dec_l, pre_l, rerouted,
                 before) -> list:
    """12b's tie check, per layer: every token's routing is its logits'
    top-k in both runs, and each token first rerouted at the layer has a
    gap (route_gap) in each run no larger than twice the largest move of
    its logits between the runs and an h that moved by at most WINDOW_RTOL
    relative. Prints and returns the readings; fails on a token that breaks
    one."""
    out = []
    for l in range(len(dec_e)):
        g_dec, g_pre = route_gap(dec_l[l], dec_e[l]), route_gap(pre_l[l],
                                                                pre_e[l])
        move = (dec_l[l] - pre_l[l]).abs().amax(-1)
        h_move = ((dec_h[l] - pre_h[l]).norm(dim=-1)
                  / pre_h[l].norm(dim=-1).clamp(min=1e-30))
        first = rerouted[l] & ~before[l]
        held = ~rerouted[l] & ~before[l]
        row = {"layer": l, "first_rerouted": int(first.sum()),
               "min_gap": float(torch.minimum(g_dec, g_pre).min()),
               "median_gap": float(g_pre.median()),
               "median_h_move_held": float(h_move[held].median())}
        if row["first_rerouted"]:
            gap = torch.maximum(g_dec, g_pre)[first]
            row.update(max_gap_rerouted=float(gap.max()),
                       max_excess=float((gap - 2 * move[first]).max()),
                       max_logit_move=float(move[first].max()),
                       max_h_move_rerouted=float(h_move[first].max()))
        out.append(row)
        print(f"window ties, layer {l}: {row['first_rerouted']} tokens first "
              f"rerouted; least route gap of any token {row['min_gap']:.3e}, "
              f"median {row['median_gap']:.3e}; h moved median "
              f"{row['median_h_move_held']:.3e} (held tokens)"
              + (f"; rerouted: largest gap {row['max_gap_rerouted']:.3e}, "
                 f"largest logit move {row['max_logit_move']:.3e}, gap less "
                 f"twice the move at most {row['max_excess']:.3e}, h moved "
                 f"at most {row['max_h_move_rerouted']:.3e}"
                 if row["first_rerouted"] else ""))
        if row["min_gap"] < -WINDOW_GAP_EPS:
            fail(f"12b: layer {l} routed a token to experts that are not "
                 f"its logits' top-k (gap {row['min_gap']:.3e})")
        if row["first_rerouted"] and row["max_excess"] > WINDOW_GAP_EPS:
            fail(f"12b: a token rerouted at layer {l} has a route gap "
                 f"{row['max_excess']:.3e} above twice its logits' move")
        if (row["first_rerouted"]
                and row["max_h_move_rerouted"] > WINDOW_RTOL):
            fail(f"12b: a token rerouted at layer {l} has an h that moved "
                 f"by {row['max_h_move_rerouted']:.3e} > {WINDOW_RTOL}")
    return out


def window_phase(params, dev) -> dict:
    """12b: full-width mixtral (as 12a) made dropless (capacity_factor 4.0),
    batch 1, cache_len = window = 4096: a 4088-token prompt, then 16 decode
    steps without reuse, eagerly and through the graphs (bitwise equal);
    steps 9-16 write rolled slots. The KV cache after step 16 against a
    windowed prefill of the same 4104 tokens into a fresh cache, slot for
    slot, and the last logits. A token whose expert choice differs between
    the two runs at some layer (two gates tied within the runs' bf16
    roundings) has its K and V at the later layers computed through other
    experts: those slots are counted, not held; layer 0 comes before any
    expert. Each token first rerouted at a layer is held to the tie: its
    router-logit gap in each run against its logits' move, and its h's
    relative move against WINDOW_RTOL (see WINDOW_GAP_EPS)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.compiled_step import CompiledStep
    from repro_torch.serve.serve_step import init_serve_state, prefill_step

    cfg = moe_cfg("mixtral-8x7b", capacity_factor=4.0)
    window, n_layers = cfg.window, cfg.n_layers
    n_rolled = WINDOW_PROMPT + WINDOW_STEPS - window
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    prompt = torch.randint(0, cfg.vocab, (1, WINDOW_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    orig_route, routes, inputs, logits_of = moe_mod.route, [], [], []

    def recording(p, cfg_, h):
        top_e, top_g = orig_route(p, cfg_, h)
        routes.append(top_e.sort(dim=-1).values.clone())
        inputs.append(h.float())
        logits_of.append(h.float() @ p["router"])
        return top_e, top_g

    runs = []
    for graphs in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        state = init_serve_state(cfg, 1, window, device=dev)
        step = CompiledStep(params, cfg, state, batch=1, graphs=graphs)
        moe_mod.route = orig_route if graphs else recording
        try:
            t0 = time.perf_counter()
            logits = [step.prefill(prompt).clone()]
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            first = {k: v[:, :, :n_rolled].clone()
                     for k, v in state["blocks"].items()}
            toks, t0 = [], time.perf_counter()
            for _ in range(WINDOW_STEPS):
                toks.append(logits[-1][:, -1:].argmax(-1).to(torch.int32))
                logits.append(step.decode(toks[-1]).clone())
            torch.cuda.synchronize()
        finally:
            moe_mod.route = orig_route
        runs.append({"logits": logits, "toks": toks, "first": first,
                     "kv": {k: v.clone() for k, v in state["blocks"].items()},
                     "len": int(state["len"]), "prefill_s": t_pre,
                     "decode_s": time.perf_counter() - t0,
                     "captures": step.captures})
        del step, state
    eager, graph = runs
    if not (all(torch.equal(a, b) for a, b in zip(eager["logits"],
                                                  graph["logits"]))
            and all(torch.equal(eager["kv"][k], graph["kv"][k])
                    for k in ("k", "v"))):
        fail("12b: the graph run differs from the eager run")
    if eager["len"] != WINDOW_PROMPT + WINDOW_STEPS:
        fail(f"12b: length {eager['len']}")
    print(f"window: {WINDOW_PROMPT}-token prompt + {WINDOW_STEPS} decode "
          f"steps, cache {window} slots: the graph run ({graph['captures']} "
          "captures) bitwise the eager run (logits, K and V); prefill "
          f"{eager['prefill_s']:.2f} s eager, {graph['prefill_s']:.2f} s "
          f"with its capture; decode {eager['decode_s']:.2f} s eager, "
          f"{graph['decode_s']:.2f} s as graphs")
    # the eager run's expert choices, router inputs and logits by layer: the
    # prompt's, then a step's
    def by_layer(calls):
        return [torch.cat([calls[l]] + [calls[n_layers * (1 + i) + l]
                                        for i in range(WINDOW_STEPS)])
                for l in range(n_layers)]

    decoded, dec_h, dec_logits = (by_layer(c) for c in (routes, inputs,
                                                         logits_of))
    for c in (routes, inputs, logits_of):
        c.clear()
    full = torch.cat([prompt] + eager["toks"], dim=1)
    gc.collect()
    torch.cuda.empty_cache()
    fresh = init_serve_state(cfg, 1, window, device=dev)
    moe_mod.route = recording
    try:
        with torch.no_grad():
            pre_logits, fresh = prefill_step(params, cfg, full, fresh)
        torch.cuda.synchronize()
    finally:
        moe_mod.route = orig_route
    rerouted = [(decoded[l] != routes[l]).any(-1) for l in range(n_layers)]
    # [L, T]: the token took other experts at a layer before this one
    before = torch.zeros((n_layers, full.shape[1]), dtype=torch.bool,
                         device=dev)
    for l in range(1, n_layers):
        before[l] = before[l - 1] | rerouted[l - 1]
    positions = torch.arange(full.shape[1] - window, full.shape[1],
                             device=dev)
    held = ~before[:, positions]                  # [L, slots in slot order]
    held = held[:, torch.argsort(positions % window)]
    res = {"rtol": WINDOW_RTOL,
           "rerouted_by_layer": [int(r.sum()) for r in rerouted],
           "not_held_by_layer": [int((~h).sum()) for h in held],
           "ties": tie_readings(decoded, routes, dec_h, inputs, dec_logits,
                                logits_of, rerouted, before)}
    print(f"window: tokens whose expert choice differs between the decode "
          f"run and the prefill, by layer: {res['rerouted_by_layer']} of "
          f"{full.shape[1]}; cache slots not held (a token rerouted at an "
          f"earlier layer), by layer: {res['not_held_by_layer']} of {window}")
    del dec_h, dec_logits
    inputs.clear()
    logits_of.clear()
    for k in ("k", "v"):
        dec, pre = eager["kv"][k].float(), fresh["blocks"][k].float()
        # [L, slots]: relative L2 error of each slot's heads (batch 1)
        err = ((dec - pre).flatten(3).norm(dim=-1)
               / pre.flatten(3).norm(dim=-1).clamp(min=1e-30))[:, 0]
        err_held = torch.where(held, err, torch.zeros_like(err))
        rolled = err_held[:, :n_rolled]
        # what a slot holding another position shows: the rolled slots
        # against the prompt's first tokens, which they held before
        old = eager["first"][k].float()
        wrong = ((dec[:, :, :n_rolled] - old).flatten(3).norm(dim=-1)
                 / old.flatten(3).norm(dim=-1).clamp(min=1e-30))
        res[k] = {"max_held": float(err_held.max()),
                  "median": float(err.median()),
                  "max_all": float(err.max()),
                  "rolled_max": float(rolled.max()),
                  "other_position_min": float(wrong.min())}
        print(f"window {k} cache after step {WINDOW_STEPS} against the "
              f"windowed prefill of {full.shape[1]} tokens: per-slot relative "
              f"L2 error of the held slots max {float(err_held.max()):.3e} "
              f"(by layer "
              + " ".join(f"{float(e):.2e}" for e in err_held.amax(dim=1))
              + f"), median of all {float(err.median()):.3e}, max of all "
              f"{float(err.max()):.3e}; rolled slots 0-{n_rolled - 1} max "
              f"{float(rolled.max()):.3e} (against the prompt positions "
              f"they held before: min {float(wrong.min()):.3e})")
        if float(wrong.min()) <= WINDOW_RTOL:
            fail(f"12b: a rolled {k} slot still holds its prompt position")
        if float(err_held.max()) > WINDOW_RTOL:
            fail(f"12b: a {k} slot differs from the windowed prefill's by "
                 f"{float(err_held.max()):.3e} > {WINDOW_RTOL}")
    a, b = eager["logits"][-1].float(), pre_logits.float()
    lerr = float((a - b).norm() / b.norm())
    last_held = not bool(before[-1, -1] | rerouted[-1][-1])
    res.update(logits_rel=lerr, last_token_held=last_held,
               argmax_equal=bool(torch.equal(a.argmax(-1), b.argmax(-1))))
    print(f"window: last decode logits against the prefill's last logits: "
          f"relative L2 {lerr:.3e}, max |diff| {float((a - b).abs().max()):.3e}"
          f", argmax equal {res['argmax_equal']}; the last token's experts "
          f"{'agree at every layer' if last_held else 'differ (not held)'}")
    if last_held and lerr > WINDOW_RTOL:
        fail(f"12b: logits differ by {lerr:.3e} > {WINDOW_RTOL}")
    res["prefill_s"], res["decode_s"] = eager["prefill_s"], eager["decode_s"]
    del fresh, runs, eager, graph
    return res


def compact_phase(cfg, params, serve_pair, serve_argv, dev,
                  max_err) -> tuple[dict, dict]:
    """12d on qwen3-32b (phase 4's config): run_measured_decode at
    correlation 0.95, batch 2, 24 steps, with a policy pinning compact at
    attn_qkv and mlp_in at a budget of ceil(gk/4), eager-checked then as
    graphs (bitwise); the budget must overflow on some steps and not on
    others. Then phase 4's serve with --impl jnp (auto sites run dense),
    and the jnp tier's runner with the exec-path refresh after each step,
    whose promotions go to compact. Returns (the JSON row, {run:
    launches})."""
    from repro_torch.core.policy import ReusePolicy, SiteTunables

    gk = {s: k // BK for s, k, _, _ in SITES}
    budgets = {s: -(-gk[s] // 4) for s in COMPACT_SITES}
    launches, out = {}, {"budgets": budgets}
    label = "qwen3 b2 compact"
    print(f"--- {label}: compact pinned at "
          + ", ".join(f"{s} (gk {gk[s]}, budget {b})"
                      for s, b in budgets.items()))
    md, counts, log = measured_pair(
        label, "qwen3-32b", cfg, params, steps=COMPACT_STEPS,
        batch=COMPACT_BATCH, dev=dev, max_err=max_err,
        policy=lambda: ReusePolicy(site_tunables={
            s: SiteTunables(exec_path="compact", max_active_k=b)
            for s, b in budgets.items()}))
    out["pinned"] = measured_summary(label, md, counts, log)
    launches[label] = counts
    ovf = {(r.site, r.layer): r.overflow_fallbacks
           for r in md.report.per_layer if r.site in COMPACT_SITES}
    paths = {s.site: s.exec_path for s in md.report.per_site}
    print(f"{label}: overflow fallbacks by layer (of {COMPACT_STEPS} steps): "
          + "; ".join(f"{s} " + " ".join(str(ovf[(s, i)])
                                        for i in range(cfg.n_layers))
                      for s in COMPACT_SITES))
    out["overflow"] = {f"{s}@{i}": v for (s, i), v in ovf.items()}
    for s in COMPACT_SITES:
        if paths[s] != "compact":
            fail(f"{label}: site {s} ran {paths[s]}, not compact")
    if not 0 < ovf[("attn_qkv", 0)] < COMPACT_STEPS:
        fail(f"{label}: layer 0 attn_qkv overflowed on "
             f"{ovf[('attn_qkv', 0)]} of {COMPACT_STEPS} steps: the budget "
             "must overflow on some steps and not on others")
    del md

    label = "qwen3 serve --impl jnp"
    counts, _ = serve_pair(cfg, serve_argv + ["--impl", "jnp"], label,
                           pairs=2)
    launches[f"{label} (eager, checked)"] = counts
    if counts["delta_quant"] <= 0 or any(
            counts[kn] for kn in ("reuse_matmul_output", "reuse_matmul_input",
                                  "reuse_matmul_ragged")):
        fail(f"{label}: the auto sites must run dense (delta_quant and no "
             f"ΔW GEMM kernel): {counts}")
    print(f"{label}: every auto site ran dense: delta_quant launched, no ΔW "
          "GEMM kernel")

    # the exec-path refresh alone after each step: the mode refresh would
    # demote the deeper layers' lanes (their similarity is below the
    # threshold), whose full tiles keep the site's skip under the gate
    label = "qwen3 b2 jnp tier with the exec refresh"
    print(f"--- {label}")
    md, counts, log = measured_pair(
        label, "qwen3-32b", cfg, params, steps=COMPACT_STEPS,
        batch=COMPACT_BATCH, dev=dev, max_err=max_err, policy=lambda: None,
        impl="jnp", on_step=lambda i, engine, rcache:
        engine.refresh_exec_paths(rcache))
    out["jnp_exec_refresh"] = measured_summary(label, md, counts, log)
    launches[label] = counts
    paths = {n: s.exec_path for n, s in md.engine.sites.items()}
    print(f"{label}: exec paths after the run {paths}")
    out["jnp_paths"] = paths
    if "compact" not in paths.values():
        fail(f"{label}: the refresh promoted no site to compact")
    if set(paths.values()) - {"auto", "compact"}:
        fail(f"{label}: a promotion left the jnp tier: {paths}")
    del md
    return out, launches


def expert_reuse_phase(params, dev) -> dict:
    """12e: per-(slot, expert) reuse at mixtral width, one layer (12a's
    layer 0), batch 8, on the reference test's stream (a drifting input, so
    routing switches, then half the slots revisiting, then every slot). The
    wi lane, and the output from the lane's own activation codes, against
    the quantized dense top-1 reference in f32 (widened weights), within the
    f32 GEMM tolerance; the activation codes against the reference's; a
    slot that repeats its expert and codes skips every tile."""
    from repro_torch.core import expert_reuse as er
    from repro_torch.models.layers import apply_norm
    from repro_torch.quant import dequantize_int8, quantize_int8

    cfg = moe_cfg("mixtral-8x7b", top_k=1)
    p = {k: (v[0] if isinstance(v, torch.Tensor) else {"scale": v["scale"][0]})
         for k, v in params["blocks"]["moe"].items()}
    b, d = EXPERT_REUSE_B, cfg.d_model
    cache = er.layer_slice(er.init_expert_reuse_cache(cfg, b, device=dev), 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    x = torch.randn((b, 1, d), generator=gen, device=dev)
    xs = []
    for _ in range(EXPERT_REUSE_STEPS):
        x = x + 0.3 * torch.randn((b, 1, d), generator=gen, device=dev)
        xs.append(x)
    half = xs[-1].clone()
    half[: b // 2] += 0.2 * torch.randn((b // 2, 1, d), generator=gen,
                                        device=dev)
    xs += [half, half]
    rows, experts, flips, worst = [], set(), 0, 0.0
    ar = torch.arange(b, device=dev)
    for i, x in enumerate(xs):
        prev_top = cache["prev_q"].abs().sum(-1) > 0
        out, cache, st = er.moe_reuse_forward(p, cfg, x, cache)
        h = apply_norm(p["norm"], x, cfg.norm_eps).reshape(b, d)
        logits = h.float() @ p["router"]
        top_e = logits.argmax(-1)
        gate = torch.softmax(logits, -1)[ar, top_e]
        s, sa = cache["scale"], cache["act_scale"]
        hq = dequantize_int8(quantize_int8(h, s), s)
        hi = torch.einsum("bd,bdf->bf", hq, p["wi"][top_e].float())
        g, u = torch.chunk(hi, 2, dim=-1)
        act_q = quantize_int8(torch.nn.functional.silu(g) * u, sa)
        lane_hi = cache["prev_hi"][top_e, ar]
        lane_act = cache["prev_act_q"][top_e, ar]
        worst = max(worst, close(lane_hi, hi, F32_ATOL, F32_RTOL,
                                 "12e wi lane"))
        flips += int((lane_act != act_q).sum())
        want = torch.einsum("bf,bfd->bd", dequantize_int8(lane_act, sa),
                            p["wo"][top_e].float()) * gate[:, None]
        worst = max(worst, close(out.reshape(b, d), want, F32_ATOL, F32_RTOL,
                                 "12e output"))
        experts |= set(top_e.tolist())
        rows.append({"step": i + 1, "sticky": float(st.sticky_fraction),
                     "wi_skip": float(st.wi_skip),
                     "wo_skip": float(st.wo_skip),
                     "lanes_warm": int(prev_top[top_e, ar].sum())})
        del hi, want
    n_codes = len(xs) * b * cfg.d_ff
    print("expert reuse (mixtral width, layer 0, batch 8, block_k 128): "
          "per step sticky / wi_skip / wo_skip: "
          + "; ".join(f"{r['step']}: {r['sticky']:.3f} {r['wi_skip']:.3f} "
                      f"{r['wo_skip']:.3f}" for r in rows)
          + f"; experts visited {sorted(experts)}; max |err| {worst:.3e} "
          f"(atol {F32_ATOL} rtol {F32_RTOL}); activation codes differing "
          f"from the reference's {flips} of {n_codes}")
    if len(experts) < 2:
        fail("12e: the stream never switched experts")
    if flips > ACT_FLIP_SHARE * n_codes:
        fail(f"12e: {flips} activation codes differ from the reference's")
    if rows[-1]["wi_skip"] != 1.0 or rows[-1]["wo_skip"] != 1.0:
        fail("12e: slots that repeat their expert and codes skipped "
             f"{rows[-1]['wi_skip']} / {rows[-1]['wo_skip']} of their tiles")
    if rows[-2]["wi_skip"] < 0.5:
        fail("12e: the revisiting half of the slots did not skip")
    return {"steps": rows, "max_err": worst, "act_code_flips": flips,
            "experts": sorted(experts)}


# phase 13: the remaining decoder archetypes on the compiled serve, at
# published widths (zamba2 uncut; the others cut in depth to fit one card
# with phase 4's traffic), a Mamba2 recurrence check, gemma3's rolling local
# window, and the LM head as one bf16 product against the earlier widened
# head
ARCHETYPE_LAYERS = {"zamba2-2.7b": 54, "gemma3-12b": 12, "qwen2-72b": 4,
                    "nemotron-4-15b": 8, "qwen2-vl-7b": 8}
# 13a: prefill 32 tokens, then 16 decode steps without reuse, against one
# prefill of the 48 tokens; at 2 superblocks (12 Mamba2 blocks, both
# superblocks' shared-block KV caches)
MAMBA_LAYERS, MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS = 12, 2, 32, 16
# 13b: one superblock (5 local layers at window 1024, 1 global), batch 1,
# cache 2048: the local caches roll at 1024 slots after the 1016-token
# prompt's 8th decode step
LOCAL_LAYERS, LOCAL_CACHE, LOCAL_PROMPT, LOCAL_STEPS = 6, 2048, 1016, 16
# a slot, a layer's state or the last logits that hold the right tokens
# differ from a prefill's by bf16 roundings in another order; one that holds
# another position differs by the values themselves (12b's limit)
ARCH_RTOL = 5e-2
# 13d: the step with the earlier LM head (widened to f32 a vocabulary chunk
# at a time) against this tree's (one bf16 product with an f32 result)
HEAD_LAYERS = {"qwen3-32b": 8, "llama4-scout-17b-a16e": 2, "gemma3-12b": 12}


def archetype_cfg(name: str, n_layers: int | None = None):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name),
                               n_layers=n_layers or ARCHETYPE_LAYERS[name])


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in tensor_leaves(tree).values())


def rel_l2(a: torch.Tensor, b: torch.Tensor, dims: int) -> torch.Tensor:
    """Relative L2 error of a against b over their last `dims` axes."""
    a, b = a.float().flatten(-dims), b.float().flatten(-dims)
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)


def weight_copy_check(step, cfg) -> dict:
    """13c on qwen2-72b, whose mlp_out has K = 29568 = 115.5 tiles of 256:
    one eager decode step hands every layer's mlp_out weight itself (its own
    storage and rows) to the kernel wrapper, and in one profiled replay no
    kernel but the GEMMs takes as long as reading that weight once at the
    HBM rate (a copy of it takes at least twice that)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import reuse_matmul as rm

    wo = step.params["blocks"]["mlp"]["wo"]
    ptrs = {wo[l].data_ptr() for l in range(cfg.n_superblocks)}
    seen, orig = [], rm.reuse_matmul

    def recording(d, w, *a, **kw):
        seen.append((w.data_ptr(), tuple(w.shape)))
        return orig(d, w, *a, **kw)

    rm.reuse_matmul = recording
    try:
        with torch.no_grad():
            step.run_decode()
        torch.cuda.synchronize()
    finally:
        rm.reuse_matmul = orig
    tail = [s for s in seen if s[1][0] == cfg.d_ff]
    if len(tail) != cfg.n_superblocks or any(
            ptr not in ptrs or shape != (cfg.d_ff, cfg.d_model)
            for ptr, shape in tail):
        fail(f"qwen2-72b mlp_out: the kernel was not handed the weight "
             f"itself ({tail})")
    read_ms = cfg.d_ff * cfg.d_model * 2 / HBM_BYTES_PER_S * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.decode(step.tokens)
        torch.cuda.synchronize()
    gemm = ("gemm", "nvjet", "cutlass", "xmma", "delta_quant")
    kernels = [(e.device_time_total / 1e3, e.name) for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not any(g in e.name.lower() for g in gemm)]
    worst = max(kernels, default=(0.0, "none"))
    print(f"qwen2-72b mlp_out (K 29568 = 115.5 tiles of 256): the kernel got "
          f"each of the {len(tail)} layers' weight itself (no pad, no copy); "
          f"in one profiled replay the longest kernel other than a GEMM "
          f"takes {worst[0]:.4f} ms ({worst[1][:70]}), against "
          f"{read_ms:.4f} ms to read the weight once at 3.35 TB/s")
    if worst[0] >= read_ms:
        fail("qwen2-72b: a kernel of the replay takes as long as a copy of "
             "mlp_out's weight")
    return {"weight_calls": len(tail), "longest_other_ms": worst[0],
            "longest_other": worst[1], "weight_read_ms": read_ms}


def archetype_serve_phase(serve_pair, graph_rows,
                          keep=None) -> tuple[dict, dict]:
    """13a-c: phase 4's traffic with --reuse on each archetype, the checked
    eager serve then the graph serve, held equal (qwen2-72b's graph serve
    kept in `keep`, with its row, for phase 14b). Returns ({serve: its
    readings}, {serve: launches})."""
    from repro_torch.configs import get_config

    card = torch.cuda.get_device_properties(0).total_memory
    out, launches = {}, {}
    for name, label in (("zamba2-2.7b", "zamba2 serve"),
                        ("gemma3-12b", "gemma3 serve"),
                        ("qwen2-72b", "qwen2-72b serve"),
                        ("nemotron-4-15b", "nemotron serve"),
                        ("qwen2-vl-7b", "qwen2-vl serve")):
        cfg = archetype_cfg(name)
        argv = ["--arch", name, "--reuse", "--batch-slots", "8",
                "--requests", "8", "--prompt-len", "32", "--cache-len",
                "128", "--max-new", "8"]
        info = {"layers": cfg.n_layers,
                "of_layers": get_config(name).n_layers}

        def probe(step, cfg=cfg, info=info, name=name, label=label):
            info["param_bytes"] = param_bytes(step.params)
            print(f"{label}: parameters {info['param_bytes'] / 1e9:.2f} GB "
                  f"({cfg.n_layers} of {info['of_layers']} layers) of the "
                  f"card's {card / 1e9:.1f} GB")
            if name == "qwen2-72b":
                info["weight_copy"] = weight_copy_check(step, cfg)

        gc.collect()
        torch.cuda.empty_cache()
        counts, _ = serve_pair(
            cfg, argv, label, pairs=3, probe=probe,
            keep=keep if name == "qwen2-72b" else None)
        if name == "qwen2-72b" and keep is not None:
            keep["row"] = graph_rows[-1]
        launches[f"{label} (eager, checked)"] = counts
        need = ["delta_quant", "reuse_matmul_output"]
        if name == "qwen2-vl-7b":  # mlp_out: 18944 > 4 x 3584
            need.append("reuse_matmul_input")
        for kn in need:
            if counts[kn] <= 0:
                fail(f"{kn} was not launched on the {label} path")
        info.update(graph_rows[-1])
        out[label] = info
    return out, launches


def mamba_phase(dev) -> dict:
    """13a's Mamba check: zamba2 at full width, 2 superblocks, batch 2. A
    32-token prefill and 16 decode steps without reuse, through the graphs,
    against one eager prefill of the same 48 tokens: every Mamba2 block's h
    and conv state (per block and batch lane), the shared block's K and V
    (per slot) and the last logits, each to ARCH_RTOL relative L2."""
    from repro_torch.models import init_params
    from repro_torch.serve.compiled_step import CompiledStep
    from repro_torch.serve.serve_step import init_serve_state, prefill_step

    cfg = archetype_cfg("zamba2-2.7b", MAMBA_LAYERS)
    params = init_params(cfg, MEASURED_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    n = MAMBA_PROMPT + MAMBA_STEPS
    toks = torch.randint(0, cfg.vocab, (MAMBA_BATCH, n), generator=gen,
                         device=dev, dtype=torch.int32)
    state = init_serve_state(cfg, MAMBA_BATCH, 128, device=dev)
    step = CompiledStep(params, cfg, state, batch=MAMBA_BATCH, graphs=True)
    step.prefill(toks[:, :MAMBA_PROMPT])
    for i in range(MAMBA_PROMPT, n):
        last = step.decode(toks[:, i:i + 1]).clone()
    torch.cuda.synchronize()
    fresh = init_serve_state(cfg, MAMBA_BATCH, 128, device=dev)
    with torch.no_grad():
        pre_logits, fresh = prefill_step(params, cfg, toks, fresh)
    dec, pre = state["blocks"], fresh["blocks"]
    res = {"rtol": ARCH_RTOL, "layers": MAMBA_LAYERS,
           "h": float(rel_l2(dec["mamba"]["h"], pre["mamba"]["h"], 3).max()),
           "conv": float(rel_l2(dec["mamba"]["conv"], pre["mamba"]["conv"],
                                2).max()),
           "logits": float(rel_l2(last, pre_logits, 1).max())}
    for k in ("k", "v"):
        res[f"shared_{k}"] = float(rel_l2(dec["shared_kv"][k][:, :, :n],
                                          pre["shared_kv"][k][:, :, :n],
                                          2).max())
    res["argmax_equal"] = bool(torch.equal(last.argmax(-1),
                                           pre_logits.argmax(-1)))
    print(f"mamba: zamba2 {MAMBA_LAYERS} layers, batch {MAMBA_BATCH}: "
          f"{MAMBA_PROMPT}-token prefill + {MAMBA_STEPS} decode steps "
          f"(graphs, no reuse) against one prefill of {n} tokens, max "
          f"relative L2: h {res['h']:.3e} (per block and lane), conv "
          f"{res['conv']:.3e}, shared K {res['shared_k']:.3e} / V "
          f"{res['shared_v']:.3e} (per slot), last logits {res['logits']:.3e}"
          f" (argmax equal: {res['argmax_equal']}); limit {ARCH_RTOL}")
    for key in ("h", "conv", "shared_k", "shared_v", "logits"):
        if not res[key] <= ARCH_RTOL:
            fail(f"13a: Mamba {key} differs from the prefill's by "
                 f"{res[key]:.3e} > {ARCH_RTOL}")
    del params, step, state, fresh
    return res


def local_window_phase(dev) -> dict:
    """13b's window check: gemma3 at full width, one superblock, batch 1,
    cache 2048 (local caches of 1024 slots): a 1016-token prompt and 16
    decode steps without reuse, through the graphs (steps 9-16 roll the
    local caches), against one windowed prefill of the same 1032 tokens:
    the local caches slot for slot, the global cache's first 1032 slots and
    the last logits, to ARCH_RTOL relative L2; a rolled slot must differ
    from the prompt position it held by more."""
    from repro_torch.models import init_params
    from repro_torch.serve.compiled_step import CompiledStep
    from repro_torch.serve.serve_step import init_serve_state, prefill_step

    cfg = archetype_cfg("gemma3-12b", LOCAL_LAYERS)
    params = init_params(cfg, MEASURED_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    prompt = torch.randint(0, cfg.vocab, (1, LOCAL_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    n, slots = LOCAL_PROMPT + LOCAL_STEPS, min(cfg.window, LOCAL_CACHE)
    n_rolled = n - slots
    state = init_serve_state(cfg, 1, LOCAL_CACHE, device=dev)
    step = CompiledStep(params, cfg, state, batch=1, graphs=True)
    t0 = time.perf_counter()
    logits = [step.prefill(prompt).clone()]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    local = state["blocks"]["local"]
    first = {k: local[k][:, :, :, :n_rolled].clone() for k in ("k", "v")}
    toks = []
    for _ in range(LOCAL_STEPS):
        toks.append(logits[-1][:, -1:].argmax(-1).to(torch.int32))
        logits.append(step.decode(toks[-1]).clone())
    torch.cuda.synchronize()
    if int(state["len"]) != n:
        fail(f"13b: length {int(state['len'])}")
    full = torch.cat([prompt] + toks, dim=1)
    fresh = init_serve_state(cfg, 1, LOCAL_CACHE, device=dev)
    with torch.no_grad():
        pre_logits, fresh = prefill_step(params, cfg, full, fresh)
    res = {"rtol": ARCH_RTOL, "slots": slots, "rolled": n_rolled,
           "prefill_s": t_pre}
    for k in ("k", "v"):
        dec, pre = local[k], fresh["blocks"]["local"][k]
        err = rel_l2(dec, pre, 2)                 # [1, 5, 1, slots]
        wrong = rel_l2(dec[:, :, :, :n_rolled], first[k], 2)
        gerr = rel_l2(state["blocks"]["global"][k][:, :, :n],
                      fresh["blocks"]["global"][k][:, :, :n], 2)
        res[k] = {"local_max": float(err.max()),
                  "local_median": float(err.median()),
                  "rolled_max": float(err[..., :n_rolled].max()),
                  "other_position_min": float(wrong.min()),
                  "global_max": float(gerr.max())}
        r = res[k]
        print(f"local window {k}: {LOCAL_PROMPT}-token prompt + "
              f"{LOCAL_STEPS} decode steps (graphs) against a windowed "
              f"prefill of {n} tokens: local caches ({slots} slots) per-slot "
              f"relative L2 max {r['local_max']:.3e}, median "
              f"{r['local_median']:.3e}; rolled slots 0-{n_rolled - 1} max "
              f"{r['rolled_max']:.3e} (against the prompt positions they "
              f"held before: min {r['other_position_min']:.3e}); global "
              f"cache's first {n} slots max {r['global_max']:.3e}")
        if r["other_position_min"] <= ARCH_RTOL:
            fail(f"13b: a rolled local {k} slot still holds its prompt "
                 "position")
        if max(r["local_max"], r["global_max"]) > ARCH_RTOL:
            fail(f"13b: a {k} slot differs from the windowed prefill's by "
                 f"more than {ARCH_RTOL}")
    res["logits"] = float(rel_l2(logits[-1], pre_logits, 1).max())
    print(f"local window: last decode logits against the prefill's: "
          f"relative L2 {res['logits']:.3e} (limit {ARCH_RTOL}); prefill of "
          f"{LOCAL_PROMPT} tokens with its capture {t_pre:.2f} s")
    if res["logits"] > ARCH_RTOL:
        fail(f"13b: last logits differ by {res['logits']:.3e}")
    del params, step, state, fresh
    return res


def widened_logits(params, cfg, h, *, vocab_chunk: int = 16384):
    """The earlier LM head: the bf16 head widened to f32 a vocabulary chunk
    at a time, then an f32 product."""
    from repro_torch.models.layers import apply_norm

    h = apply_norm(params["final_norm"], h, cfg.norm_eps).float()
    head = params.get("lm_head")
    vocab = head.shape[1] if head is not None else params["embed"].shape[0]
    out = torch.empty((*h.shape[:-1], vocab), dtype=torch.float32,
                      device=h.device)
    for v0 in range(0, vocab, vocab_chunk):
        wt = (head[:, v0:v0 + vocab_chunk].float() if head is not None
              else params["embed"][v0:v0 + vocab_chunk].float().T)
        out[..., v0:v0 + vocab_chunk] = h @ wt
    return out


def head_phase(dev, pairs: int = 5) -> dict:
    """13d: qwen3-32b (8 layers), llama4-scout (2) and gemma3-12b (12) at
    phase 4's batch and cache: one decode step with reuse captured with the
    earlier widened LM head and with the current product, the two graphs
    replayed in turns on the same state (host clock around synchronize)."""
    from repro_torch.models import init_params
    from repro_torch.serve import serve_step as ss
    from repro_torch.serve.compiled_step import CompiledStep

    out = {}
    for name, layers in HEAD_LAYERS.items():
        cfg = archetype_cfg(name, layers)
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(cfg, MEASURED_SEED, device=dev)
        engine = ss.build_reuse_engine(cfg)
        rcache = engine.init_cache(8, device=dev)
        state = ss.init_serve_state(cfg, 8, 128, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(15)
        steps = {}
        for how in ("widened", "product"):
            steps[how] = CompiledStep(params, cfg, state, batch=8,
                                      engine=engine, rcache=rcache,
                                      graphs=True)
            if how == "widened":
                steps[how].prefill(torch.randint(
                    0, cfg.vocab, (8, 32), generator=gen, device=dev))
            orig = ss.output_logits
            if how == "widened":
                ss.output_logits = widened_logits
            try:
                steps[how].decode(torch.ones((8, 1), dtype=torch.int32,
                                             device=dev))
            finally:
                ss.output_logits = orig
        times = {"widened": [], "product": []}
        for i in range(pairs):
            for how in (("widened", "product") if i % 2 == 0
                        else ("product", "widened")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[how].decode(steps[how].tokens)
                torch.cuda.synchronize()
                times[how].append((time.perf_counter() - t0) * 1e3)
        med = {how: statistics.median(t) for how, t in times.items()}
        vocab_bytes = cfg.vocab * cfg.d_model * 2
        print(f"LM head {name} ({layers} layers, head {vocab_bytes / 1e9:.2f} "
              f"GB bf16): graph replay median with the earlier widened head "
              f"{med['widened']:.2f} ms, with one bf16 product "
              f"{med['product']:.2f} ms ({pairs} each in turns: "
              + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in
                          zip(times["widened"], times["product"])) + ")")
        out[name] = {"layers": layers, "widened_ms": med["widened"],
                     "product_ms": med["product"], "times": times}
        del steps, params, engine, rcache, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 14: sharded reuse serving (`serve --mesh host:4`: every site's cache
# and weight in 4 model-axis shards on the one card, each shard running its
# own delta_quant and its own GEMM on its column panel of the weight, read
# in place). (a) qwen3-32b at 8 layers and (b) qwen2-72b at 4 (its mlp_in
# panels end inside a tile: 14,784 columns), phase 4's traffic: the pair,
# eager-checked then graphs, then held bitwise to phases 4's and 13c's
# unsharded serves; each sharded site's 4 panel launches timed against its
# one unsharded launch; (c) the controlled serve: per-shard journal rows,
# replay, the guard's sentinels combined across shards (a NaN in shard 2's
# lane), Controller.step's device->host copies
SHARDS = 4
SHARD_ARCHS = (("qwen3-32b", N_LAYERS, "qwen3 sharded host:4", "phase 4"),
               ("qwen2-72b", 4, "qwen2-72b sharded host:4", "13c"))


def sharded_equal(label, got, want, shards) -> int:
    """The sharded serve against the unsharded one, bitwise: tokens,
    SensorReport lines, the decode state, and the reuse cache with the
    shard axis collapsed (prev_out's panels laid side by side; counters
    summed or taken from shard 0 by `COUNTER_SHARD_REDUCE`; every other
    leaf replicated, each shard's lane equal to the unsharded one). Returns
    the tensors compared."""
    from repro_torch.sensor.counters import COUNTER_SHARD_REDUCE

    for part in ("tokens", "reports"):
        if got[part] != want[part]:
            fail(f"{label}: {part} differ from the unsharded serve's")
    for key, t in want["tensors"].items():
        g = got["tensors"].get(key)
        if g is None:
            fail(f"{label}: no {key} in the sharded serve")
        if key.startswith("rcache."):
            leaf = key.rsplit(".", 1)[1]
            if leaf == "prev_out":
                layers, n_sh, m, nl = g.shape
                g = g.permute(0, 2, 1, 3).reshape(layers, m, n_sh * nl)
            elif ".sensor." in key and COUNTER_SHARD_REDUCE[leaf] == "sum":
                g = g.sum(dim=1).to(t.dtype)
            else:
                if not all(torch.equal(g.select(1, i), g.select(1, 0))
                           for i in range(shards)):
                    fail(f"{label}: the shards' lanes of {key} differ")
                g = g.select(1, 0)
        if g.shape != t.shape or not torch.equal(g, t):
            fail(f"{label}: {key} differs from the unsharded serve's")
    return len(want["tensors"])


def panel_timing(dev, sites, shards, layers) -> dict:
    """Each sharded site's ΔW GEMM at decode (M = 8, bf16, skip 0): its
    `shards` launches on the column panels of one weight, read in place
    with the unsharded k split, against the one unsharded launch (CUDA
    events over a graph of 20 calls; every weight here exceeds the 50 MB
    L2, so each call reads it from HBM)."""
    from repro_torch.kernels.reuse_matmul import reuse_matmul

    gen = torch.Generator(device=dev).manual_seed(MEASURED_SEED)
    out = {}
    for name, (k, n, flow) in sorted(sites.items()):
        kp, nl = -(-k // BK) * BK, n // shards
        delta = torch.zeros((8, kp), dtype=torch.bfloat16, device=dev)
        delta[:, :k] = torch.randn((8, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        prev = torch.randn((8, n), generator=gen, device=dev)
        prevs = [prev[:, i * nl:(i + 1) * nl].contiguous()
                 for i in range(shards)]
        mask = torch.ones((1, kp // BK), dtype=torch.int32, device=dev)
        kw = dict(block_m=8, block_n=128, block_k=BK, dataflow=flow)
        whole = time_ms(lambda: reuse_matmul(delta, w, prev, mask, **kw))
        panels = time_ms(lambda: [
            reuse_matmul(delta, w[:, i * nl:(i + 1) * nl], prevs[i], mask,
                         n_total=n, **kw) for i in range(shards)])
        bound = k * n * 2 / HBM_BYTES_PER_S * 1e3
        print(f"  {name:9s} [8,{k}]x[{k},{n}] ({flow}): 1 launch "
              f"{whole:.4f} ms; {shards} panels of {nl} columns {panels:.4f} "
              f"ms ({shards} launches); bound {bound:.4f} ms; a step of "
              f"{layers} layers {whole * layers:.3f} -> "
              f"{panels * layers:.3f} ms")
        out[name] = {"K": k, "N": n, "panel_N": nl, "dataflow": flow,
                     "unsharded_ms": whole, "panels_ms": panels,
                     "panel_launches": shards, "bound_ms": bound,
                     "step_unsharded_ms": whole * layers,
                     "step_panels_ms": panels * layers}
        del delta, w, prev, prevs
        torch.cuda.empty_cache()
    return out


def panel_copy_check(step, shards) -> dict:
    """14b: no step copies a weight. In one eager decode step (the dispatch
    recorder of `repro_torch.roofline.collectives`) no copy, cat or gather
    writes a tensor as large as the smallest weight panel; in one profiled
    replay no copy kernel takes as long as a copy of that panel (reading
    and writing it once at the HBM rate)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.roofline.collectives import trace_step

    smallest = min(sp.in_features * sp.out_features // shards
                   for sp in step.engine.sites.values())
    trace = trace_step(step.run_decode)
    big = [(op, operands[-1]) for op, operands in trace["moves"]
           if operands and math.prod(operands[-1][1]) >= smallest]
    if big:
        fail(f"a sharded step copies a weight-sized tensor: {big[:4]}")
    copy_ms = 2 * smallest * 2 / HBM_BYTES_PER_S * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.decode(step.tokens)
        torch.cuda.synchronize()
    copies = [(e.device_time_total / 1e3, e.name) for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and ("copy" in e.name.lower() or "memcpy" in e.name.lower())]
    worst = max(copies, default=(0.0, "none"))
    print(f"  no weight copied: {len(trace['moves'])} copies and gathers in "
          f"one eager step, none writing {smallest:,} elements (the smallest "
          f"panel) or more; the longest copy kernel of a replay "
          f"{worst[0]:.4f} ms ({worst[1][:60]}) against {copy_ms:.4f} ms to "
          "copy that panel")
    if worst[0] >= copy_ms:
        fail("a copy kernel of the sharded replay takes as long as copying "
             "a weight panel")
    return {"moves": len(trace["moves"]), "smallest_panel": smallest,
            "longest_copy_ms": worst[0], "panel_copy_ms": copy_ms}


def sharded_phase(serve_pair, graph_rows, unsharded, dev) -> tuple[dict, dict]:
    """14a and 14b. Returns ({serve: readings}, {serve: launches})."""
    from repro_torch.configs import get_config

    out, launches = {}, {}
    for arch, layers, label, base_label in SHARD_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        argv = ["--arch", arch, "--reuse", "--batch-slots", "8",
                "--requests", "8", "--prompt-len", "32", "--cache-len",
                "128", "--max-new", "8", "--mesh", f"host:{SHARDS}"]
        keep, sites, info = {}, {}, {"layers": layers}

        def probe(step, arch=arch, sites=sites, info=info):
            sites.update({n: (sp.in_features, sp.out_features, sp.dataflow)
                          for n, sp in step.engine.sites.items()})
            if arch == "qwen2-72b":
                info["weight_copy"] = panel_copy_check(step, SHARDS)

        gc.collect()
        torch.cuda.empty_cache()
        counts, _ = serve_pair(cfg, argv, label, pairs=3, probe=probe,
                               keep=keep)
        launches[f"{label} (eager, checked)"] = counts
        need = ["delta_quant", "reuse_matmul_output"]
        if arch == "qwen3-32b":
            need.append("reuse_matmul_input")
        for kn in need:
            if counts[kn] <= 0:
                fail(f"{kn} was not launched on the {label} path")
        text = keep["text"]
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("mesh:", "profiler no-gather", "shard skip",
                                   "ici traffic"))]
        if not any(ln.startswith("profiler no-gather check: OK")
                   for ln in lines):
            fail(f"{label}: no OK no-gather line")
        if sum(ln.startswith("shard skip") for ln in lines) != len(sites) \
                or not any(ln.startswith("ici traffic") for ln in lines):
            fail(f"{label}: shard skip or ici traffic lines missing")
        base = unsharded[arch]
        n = sharded_equal(label, keep, base, SHARDS)
        row, brow = graph_rows[-1], base["row"]
        print(f"{label}: bitwise the unsharded serve of {base_label} — tokens "
              f"of {len(keep['tokens'])} requests, "
              f"{len(keep['reports'])} SensorReport lines, {n} tensors of "
              "the final decode state and reuse cache (prev_out's panels "
              "side by side, counters collapsed)")
        print(f"{label}: replay {row['graph_ms']:.2f} ms (unsharded "
              f"{brow['graph_ms']:.2f}), device busy {row['busy_graph_ms']:.2f}"
              f" ms ({brow['busy_graph_ms']:.2f}), {row['kernels_graph']} "
              f"kernels and copies a replay ({brow['kernels_graph']}); "
              f"launches {dict(keep['counts'])} (unsharded "
              f"{dict(base['counts'])})")
        print(f"{label}: each sharded site's panels against its one "
              "unsharded launch (bf16, M = 8, skip 0):")
        info.update(row=row, unsharded_row={
            k: brow[k] for k in ("graph_ms", "eager_ms", "busy_graph_ms",
                                 "kernels_graph")},
            lines=lines, tensors=n,
            panels=panel_timing(dev, sites, SHARDS, layers))
        out[label] = info
        del keep, base
        unsharded[arch] = None
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def sharded_control_phase(cfg, argv, drive, logdir) -> dict:
    """14c: phase 4's serve at 16 new tokens with `--mesh host:4
    --control-every 2 --control-journal`: kind="shard" rows, at most one per (site, shard,
    interval); `replay_rows` verifies the journal; then one
    Controller.step with a window on every site makes 2 device->host
    copies, 3 with the QuarantineBreaker; then the same serve with a NaN
    written into shard 2's lane of the last layer's mlp_out prev_out after
    decode step 3: the breaker's snapshot (its sentinel lanes combined
    across shards) trips nonfinite_out there at step 4."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.control import (
        ControlConfig,
        Controller,
        load_journal,
        replay_rows,
    )
    from repro_torch.guard import QuarantineBreaker

    logdir.mkdir(parents=True, exist_ok=True)
    # 15 decode steps: 7 control intervals, windows past the first ones
    argv = argv + ["--mesh", f"host:{SHARDS}", "--control-every", "2",
                   "--max-new", "16"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "j.jsonl")
        res, _, text = drive(cfg, argv + ["--control-journal", journal],
                             check=False, log_to=logdir / "phase14c.log")
        rows = load_journal(journal)
        shard_rows = [r for r in rows if r.get("decision_kind") == "shard"]
        per = collections.Counter((r["site"], r["shard"], r["interval"])
                                  for r in shard_rows)
        if not shard_rows or max(per.values()) > 1 or any(
                not 0 <= r["shard"] < SHARDS for r in shard_rows):
            fail(f"14c: shard rows {len(shard_rows)}, at most "
                 f"{max(per.values(), default=0)} per (site, shard, interval)")
        rep = replay_rows(rows)
        if not rep.ok:
            fail("14c: the sharded serve's journal does not replay: "
                 + "; ".join(rep.summary_lines()[:4]))
        print(f"14c: {len(rows)} journal rows, {len(shard_rows)} kind=shard "
              f"over {len({r['interval'] for r in shard_rows})} intervals, "
              f"one per shard whose window moved; replay verifies "
              f"({rep.n_shard_scoped} shard-scoped)")
        step, eng, rc = res["step"], res["engine"], res["rcache"]
        copies = {}
        for guarded in (False, True):
            ctl = Controller(ControlConfig(min_window_steps=2),
                             guard=QuarantineBreaker() if guarded else None)
            for i in (2, 4):
                for _ in range(2):
                    step.decode(step.tokens)
                if i == 2:
                    ctl.step(eng, rc, step=i)
                    continue
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    crep = ctl.step(eng, rc, step=i)
                    torch.cuda.synchronize()
                copies[guarded] = sum(1 for e in prof.events()
                                      if "Memcpy DtoH" in e.name)
                if len(crep.window_steps) != len(eng.sites):
                    fail("14c: the profiled interval has no window on "
                         "every site")
        print(f"14c: one Controller.step on the sharded engine: "
              f"{copies[False]} device->host copies, {copies[True]} with the "
              "QuarantineBreaker")
        if (copies[False], copies[True]) != (2, 3):
            fail("14c: Controller.step must make 2 device->host copies, 3 "
                 "with the guard")
        out.update(journal_rows=len(rows), shard_rows=len(shard_rows),
                   copies=copies[False], copies_guarded=copies[True])
        del res, step, eng, rc
        gc.collect()
        torch.cuda.empty_cache()

        layer = cfg.n_superblocks - 1

        def poison(step_idx, step):
            if step_idx == 3:
                step.rcache["mlp_out"]["prev_out"][layer, 2, 0, 0] = float(
                    "nan")

        journal = os.path.join(tmp, "g.jsonl")
        _, _, text = drive(cfg, argv + ["--control-journal", journal],
                           check=False, after_step=poison,
                           log_to=logdir / "phase14c_guard.log")
        trips = [r for r in load_journal(journal)
                 if r.get("decision_kind") == "quarantine"
                 and r.get("after") == "quarantined"]
        first = trips[0] if trips else {}
        if first.get("layer") != layer or first.get("step") != 4 or \
                "nonfinite_out" not in first.get("reason", ""):
            fail(f"14c: the NaN in shard 2's lane did not trip nonfinite_out "
                 f"at layer {layer}, step 4: {first}")
        guard = [ln for ln in text.splitlines()
                 if ln.startswith("guard plane:")]
        print(f"14c: a NaN in shard 2's lane of mlp_out layer {layer} "
              f"tripped at step {first['step']}: {first['reason'][:90]}; "
              f"{guard[0] if guard else ''}")
        out.update(trip=first["reason"], guard=guard)
    return out


# phase 15: checkpointing and the int8 KV cache on the compiled serve. (a)
# phase 4's serve with --control-every 2, a tuned table pinning attn_qkv's
# sim_threshold and --cache-ckpt: the checkpoint on disk (step directory,
# sidecar, marker, hashes, manifest paths) and every stored leaf bitwise the
# run's final live cache; (b) the same serve without the table from that
# checkpoint, a pair (eager-checked, then graphs): the restore line and its
# journaled kind="restore" rows, the cache before the first step bitwise the
# checkpoint in the tensors init_cache built, the mode mirrors rebuilt; (c) a
# save with --inject corrupt-ckpt, whose next start raises before any
# capture; (d) the same round trip at --mesh host:4; (e) phase 4's serve
# with kv_cache_quant=True as a pair, the prefill's int8 codes against the
# bf16 prefill's K/V. Save, verify and restore are timed on the 8-layer and
# the host:4 caches.
CKPT_THR = 0.61   # attn_qkv's sim_threshold in 15a's table


def ck_leaves(tree, prefix: str = "") -> dict:
    """{checkpoint path: tensor} of a nested dict's tensor leaves."""
    return {k.replace(".", "/"): t
            for k, t in tensor_leaves(tree, prefix).items()}


def stored_leaves(directory, step: int) -> tuple[dict, dict]:
    """(manifest, {path: numpy array}) of a saved step, read with numpy
    alone."""
    import numpy as np

    step_dir = pathlib.Path(directory) / f"step_{step:06d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "host_00000.npz") as z:
        return manifest, {k: z[k] for k in z.files}


def bitwise_stored(label, live: dict, directory, step: int) -> int:
    """Every stored leaf equals its live tensor bit for bit (cache leaves
    are f32 and integers), with the manifest's shape and dtype tag, and the
    stored paths are the live paths. Returns the leaf count."""
    manifest, arrays = stored_leaves(directory, step)
    if set(arrays) != set(live) or set(manifest["leaves"]) != set(live):
        fail(f"{label}: stored paths differ from the cache's "
             f"({sorted(set(arrays) ^ set(live))[:6]})")
    for key, t in live.items():
        meta, arr = manifest["leaves"][key], arrays[key]
        if meta != {"shape": list(t.shape),
                    "dtype": str(t.dtype).removeprefix("torch.")} \
                or str(arr.dtype) != meta["dtype"]:
            fail(f"{label}: {key} stored as {meta} ({arr.dtype})")
        if not (arr == t.cpu().numpy()).all():
            fail(f"{label}: stored {key} differs from the live cache")
    return len(live)


@contextlib.contextmanager
def restore_probe():
    """While it lasts, records the addresses of the cache `init_cache`
    builds and, when a serve builds its CompiledStep (after the restore,
    before the first step), a copy of the cache, its addresses and its mode
    mirrors against the mode lanes."""
    from repro_torch.core.engine import ReuseEngine
    from repro_torch.launch import serve

    log = {"builds": 0}
    init_cache, compiled_step = ReuseEngine.init_cache, serve.CompiledStep

    def recording_init(self, batch, **kw):
        cache = init_cache(self, batch, **kw)
        log["ptrs"] = {k: t.data_ptr() for k, t in ck_leaves(cache).items()}
        return cache

    def recording_step(*args, rcache=None, **kw):
        log["builds"] += 1
        if rcache is not None:
            leaves = ck_leaves(rcache)
            log["at_build"] = {k: t.clone() for k, t in leaves.items()}
            log["ptrs_at_build"] = {k: t.data_ptr() for k, t in leaves.items()}
            log["mirrors"] = all(
                (e["mode_host"] == e["ctrl"]["mode_id"].cpu().numpy()).all()
                for e in rcache.values())
        return compiled_step(*args, rcache=rcache, **kw)

    ReuseEngine.init_cache, serve.CompiledStep = recording_init, recording_step
    try:
        yield log
    finally:
        ReuseEngine.init_cache, serve.CompiledStep = init_cache, compiled_step


def restored_as_saved(label, log, directory, step) -> int:
    """The probe's cache at the CompiledStep's construction is bitwise the
    checkpoint, in the tensors init_cache built, with its mode mirrors
    equal to its mode lanes."""
    if log["builds"] != 1 or "at_build" not in log:
        fail(f"{label}: {log['builds']} CompiledStep builds")
    n = bitwise_stored(label, log["at_build"], directory, step)
    if log["ptrs_at_build"] != log["ptrs"]:
        moved = [k for k in log["ptrs"]
                 if log["ptrs"][k] != log["ptrs_at_build"].get(k)]
        fail(f"{label}: restored leaves moved from init_cache's tensors: "
             f"{moved[:6]}")
    if not log["mirrors"]:
        fail(f"{label}: mode_host differs from ctrl['mode_id'] after the "
             "restore")
    return n


def ckpt_costs(label, rcache, tmp) -> dict:
    """Save, verify and restore (in place) of a live cache, timed on the
    host clock around synchronize, with the cache's and the file's bytes."""
    from repro_torch.ckpt.checkpoint import (
        restore_cache,
        save_cache,
        verify_checkpoint,
    )
    from repro_torch.core.reuse_cache import cache_bytes

    d = pathlib.Path(tmp) / "timed"
    shutil.rmtree(d, ignore_errors=True)
    times = {}
    for what, fn in (("save", lambda: save_cache(d, 1, rcache)),
                     ("verify", lambda: verify_checkpoint(d, 1)),
                     ("restore", lambda: restore_cache(d, 1, rcache))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[what] = (time.perf_counter() - t0) * 1e3
    out = {"cache_bytes": cache_bytes(rcache),
           "file_bytes": (d / "step_000001" / "host_00000.npz").stat().st_size,
           "leaves": len(ck_leaves(rcache)),
           **{f"{k}_ms": v for k, v in times.items()}}
    print(f"{label}: cache {out['cache_bytes'] / 1e6:.2f} MB in "
          f"{out['leaves']} leaves (npz {out['file_bytes'] / 1e6:.2f} MB); "
          f"save {times['save']:.1f} ms, verify {times['verify']:.1f} ms, "
          f"restore in place {times['restore']:.1f} ms (host clock around "
          "synchronize)")
    return out


def need_kernels(label, counts, names=("delta_quant", "reuse_matmul_output",
                                       "reuse_matmul_input")) -> None:
    for kn in names:
        if counts[kn] <= 0:
            fail(f"{kn} was not launched on the {label} path")


def ckpt_phase(cfg, argv, drive, logdir) -> tuple[dict, dict]:
    """15a-d. Returns ({part: readings}, {run: launches})."""
    from repro_torch.ckpt.checkpoint import (
        CorruptCheckpointError,
        cache_state,
        verify_checkpoint,
    )
    from repro_torch.control import load_journal, replay_rows
    from repro_torch.core.policy import ReusePolicy, SiteTunables
    from repro_torch.tune.table import save_table

    logdir.mkdir(parents=True, exist_ok=True)
    out, launches = {}, {}
    ctl = argv + ["--control-every", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        table = tmp / "table.json"
        save_table(str(table), {"attn_qkv": SiteTunables(
            sim_threshold=CKPT_THR)}, meta={"written_by": "chip_smoke.py"})
        d = tmp / "D"
        # ------------------------------------------------------- 15a. save
        res, counts, text = drive(
            cfg, ctl + ["--control-journal", str(tmp / "j1.jsonl"),
                        "--tuned-policy", str(table), "--cache-ckpt", str(d)],
            check=False, log_to=logdir / "phase15a.log")
        need_kernels("15a save", counts)
        launches["15a save (graph)"] = counts
        n = res["stats"]["steps"]
        step_dir = d / f"step_{n:06d}"
        for p in (step_dir / "manifest.json", step_dir / "host_00000.npz",
                  step_dir / "host_00000.npz.sha256",
                  d / f"step_{n:06d}.COMPLETE"):
            if not p.exists():
                fail(f"15a: {p.name} missing")
        if f"cache checkpoint: saved step {n} to {d}" not in text:
            fail("15a: no save line")
        verify_checkpoint(d, n)
        live = ck_leaves(cache_state(res["step"].rcache))
        n_leaves = bitwise_stored("15a", live, d, n)
        # the lanes the restore without the table must adopt: those off the
        # default (the controller may have moved the table's value)
        thr = live["attn_qkv/ctrl/sim_threshold"].tolist()
        default = ReusePolicy().resolve("attn_qkv").sim_threshold
        moved = sum(abs(v - default) > 1e-5 * default for v in thr)
        if not moved:
            fail(f"15a: attn_qkv's lanes {thr} are the defaults")
        print(f"15a: step {n} saved: {n_leaves} leaves (the cache's paths "
              "without mode_host) bitwise the final live cache; hashes "
              f"verify; attn_qkv sim_threshold per layer {thr} (table "
              f"{CKPT_THR}, default {default})")
        out["save"] = {"step": n, "leaves": n_leaves,
                       **ckpt_costs("15a qwen3 8 layers", res["step"].rcache,
                                    tmp)}
        del res, live
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------ 15b. the restore
        runs = {}
        for how in ("eager", "graph"):
            dd = tmp / f"D_{how}"
            shutil.copytree(d, dd)
            journal = tmp / f"j2_{how}.jsonl"
            with restore_probe() as log:
                res, counts, text = drive(
                    cfg, ctl + ["--control-journal", str(journal),
                                "--cache-ckpt", str(dd)]
                    + (["--eager"] if how == "eager" else []),
                    check=how == "eager", log_to=logdir / f"phase15b_{how}.log")
            need_kernels(f"15b restore ({how})", counts)
            launches[f"15b restore ({how}{', checked' * (how == 'eager')})"] \
                = counts
            n_restored = restored_as_saved(f"15b {how}", log, d, n)
            head = f"cache checkpoint: restored step {n} from {dd}; "
            lines = [ln for ln in text.splitlines()
                     if ln.startswith((head, "  restore "))]
            m = re.match(re.escape(head) + r"ctrl precedence resolved (\d+) "
                         r"lanes", lines[0] if lines else "")
            qkv = [ln for ln in lines if ln.startswith(
                "  restore attn_qkv@") and "sim_threshold" in ln]
            if not m or int(m.group(1)) < 1 or len(qkv) != moved:
                fail(f"15b {how}: restore lines {lines[:3]}")
            rows = load_journal(str(journal))
            restore_rows = [r for r in rows
                            if r.get("decision_kind") == "restore"]
            rep = replay_rows(rows)
            if len(restore_rows) != int(m.group(1)) or not rep.ok:
                fail(f"15b {how}: {len(restore_rows)} restore rows, replay "
                     f"{'ok' if rep.ok else 'failed'}")
            runs[how] = (outcome(res, text), counts, lines)
            del res
            gc.collect()
            torch.cuda.empty_cache()
        (want, counts_e, lines_e), (got, counts_g, lines_g) = (
            runs["eager"], runs["graph"])
        for part in ("tokens", "reports", "modes"):
            if got[part] != want[part]:
                fail(f"15b: the graph serve's {part} differ from the eager "
                     "serve's")
        diff = [k for k, t in want["tensors"].items()
                if not torch.equal(t, got["tensors"][k])]
        if diff or counts_g != counts_e:
            fail(f"15b: graph serve vs eager: tensors {diff[:6]}, launches "
                 f"{counts_g} vs {counts_e}")
        if [ln.split(" from ")[0] for ln in lines_e] != [
                ln.split(" from ")[0] for ln in lines_g]:
            fail("15b: the serves resolved the restore differently")
        print(f"15b: both serves restored step {n}: {lines_g[0].split('; ')[1]}"
              f"; {len(restore_rows)} kind=\"restore\" rows, the journal "
              f"replays; before the first step {n_restored} leaves bitwise "
              "the checkpoint in init_cache's tensors, mode_host rebuilt; "
              f"the graph serve equal to the checked eager serve (tokens, "
              f"{len(got['reports'])} report lines, {len(got['tensors'])} "
              "tensors bitwise)")
        out["restore"] = {"resolved": len(restore_rows),
                          "line": lines_g[0], "leaves": n_restored}
        del runs, want, got

        # ------------------------------------ 15c. a corrupted checkpoint
        dc = tmp / "C"
        _, counts, text = drive(
            cfg, argv + ["--cache-ckpt", str(dc), "--inject", "corrupt-ckpt",
                         "--eager"], check=False,
            log_to=logdir / "phase15c.log")
        launches["15c corrupt-ckpt save (eager)"] = counts
        fired = [ln.strip() for ln in text.splitlines()
                 if "corrupt-ckpt @step -1: flipped" in ln]
        if not fired:
            fail("15c: corrupt-ckpt did not fire")
        with restore_probe() as log:
            try:
                drive(cfg, argv + ["--cache-ckpt", str(dc)], check=False)
            except CorruptCheckpointError as e:
                raised = str(e)
            else:
                fail("15c: a start on the corrupted checkpoint served")
        if log["builds"]:
            fail("15c: a CompiledStep was built before the raise")
        print(f"15c: {fired[0]}; the next start raised CorruptCheckpointError "
              f"before any capture: {raised[raised.find('sha256'):]}")
        out["corrupt"] = {"fired": fired[0], "raised": raised}
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------ 15d. a host:4 cache
        ds = tmp / "S"
        res, counts, text = drive(
            cfg, argv + ["--mesh", f"host:{SHARDS}", "--cache-ckpt", str(ds)],
            check=False, log_to=logdir / "phase15d_save.log")
        need_kernels("15d sharded save", counts)
        launches["15d host:4 save (graph)"] = counts
        ns = res["stats"]["steps"]
        live = ck_leaves(cache_state(res["step"].rcache))
        bitwise_stored("15d", live, ds, ns)
        manifest, _ = stored_leaves(ds, ns)
        shape = manifest["leaves"]["mlp_in/prev_out"]["shape"]
        n_out = res["engine"].sites["mlp_in"].out_features
        if shape != [cfg.n_superblocks, SHARDS, 8, n_out // SHARDS]:
            fail(f"15d: stored mlp_in prev_out is {shape}")
        out["sharded"] = {"step": ns, "prev_out_shape": shape,
                          **ckpt_costs(f"15d qwen3 host:{SHARDS}",
                                       res["step"].rcache, tmp)}
        del res, live
        gc.collect()
        torch.cuda.empty_cache()
        # the restoring serve saves its own final cache at the same step
        # number at exit: it gets a copy
        shutil.copytree(ds, tmp / "S_restore")
        with restore_probe() as log:
            _, counts, text = drive(
                cfg, argv + ["--mesh", f"host:{SHARDS}", "--cache-ckpt",
                             str(tmp / "S_restore"), "--eager"],
                check=False, log_to=logdir / "phase15d_restore.log")
        need_kernels("15d sharded restore", counts)
        launches["15d host:4 restore (eager)"] = counts
        n_sharded = restored_as_saved("15d", log, ds, ns)
        if not any(ln.startswith("profiler no-gather check: OK")
                   for ln in text.splitlines()):
            fail("15d: no OK no-gather line after the restore")
        print(f"15d: host:{SHARDS} step {ns} saved with mlp_in prev_out "
              f"{shape} ([L, S, B, N/S]) and restored into a host:{SHARDS} "
              f"serve: {n_sharded} leaves bitwise before its first step, in "
              "init_cache's tensors")
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def kv_quant_phase(cfg, argv, serve_pair, graph_rows, dev) -> tuple[dict,
                                                                    dict]:
    """15e. Phase 4's serve with kv_cache_quant=True as a pair; on the graph
    serve's weights, a prefill of 8 random 32-token prompts into an int8 and
    a bf16 state: the int8 codes are the bf16 K/V quantized, bitwise
    (prefill attends over the unquantized K/V)."""
    from repro_torch.serve.serve_step import init_serve_state, prefill_step

    qcfg = dataclasses.replace(cfg, kv_cache_quant=True)
    info = {}

    def probe(step):
        blocks = step.state["blocks"]
        if blocks["k"].dtype != torch.int8 or blocks["v"].dtype != torch.int8:
            fail("15e: the served K/V caches are not int8")
        plain = init_serve_state(cfg, 8, 128, device=dev)
        q_bytes = sum(blocks[k].numel() * blocks[k].element_size()
                      for k in ("k", "v"))
        b_bytes = sum(plain["blocks"][k].numel()
                      * plain["blocks"][k].element_size() for k in ("k", "v"))
        dtype = str(cfg.dtype).removeprefix("torch.")
        if q_bytes * plain["blocks"]["k"].element_size() != b_bytes:
            fail(f"15e: int8 K/V {q_bytes} B against {dtype} {b_bytes} B")
        gen = torch.Generator(device=dev)
        gen.manual_seed(15)
        toks = torch.randint(0, cfg.vocab, (8, 32), generator=gen, device=dev,
                             dtype=torch.int32)
        with torch.no_grad():
            _, plain = prefill_step(step.params, cfg, toks, plain)
            _, quant = prefill_step(step.params, qcfg, toks, init_serve_state(
                qcfg, 8, 128, device=dev))
        for k in ("k", "v"):
            want = torch.clamp(torch.round(
                plain["blocks"][k][:, :, :32].float() / qcfg.kv_quant_scale),
                -127, 127).to(torch.int8)
            got = quant["blocks"][k][:, :, :32]
            if not torch.equal(got, want):
                fail(f"15e: prefill {k} codes differ from the bf16 prefill's "
                     f"quantized ({int((got != want).sum())} codes)")
            if quant["blocks"][k][:, :, 32:].any():
                fail(f"15e: prefill wrote {k} past the prompt")
        info.update(kv_bytes=q_bytes, kv_bytes_plain=b_bytes,
                    codes_checked=2 * want.numel())
        print(f"15e: K/V caches int8, {q_bytes / 1e6:.2f} MB against {dtype} "
              f"{b_bytes / 1e6:.2f} MB; after a prefill of 8x32 tokens "
              f"{2 * want.numel()} codes bitwise clip(round(kv/"
              f"{qcfg.kv_quant_scale})) of the {dtype} prefill's K/V")

    counts, _ = serve_pair(qcfg, argv, "qwen3 int8 kv", pairs=3, probe=probe)
    need_kernels("15e int8 KV serve", counts)
    row = graph_rows[-1]
    base = next(r for r in graph_rows if r["serve"] == "qwen3 default")
    print(f"15e: int8 KV replay {row['graph_ms']:.2f} ms, busy "
          f"{row['busy_graph_ms']:.2f} ms, {row['kernels_graph']} kernels and "
          f"copies (phase 4's bf16 cache: {base['graph_ms']:.2f} ms, "
          f"{base['busy_graph_ms']:.2f} ms, {base['kernels_graph']})")
    info.update(row=row, phase4={k: base[k] for k in (
        "graph_ms", "busy_graph_ms", "kernels_graph", "eager_ms")})
    return info, {"15e int8 kv (eager, checked)": counts}


# phase 16: training at full width (repro_torch.{train,optim,data},
# launch/train under ResilientLoop), cut in depth in-process. (a) qwen3-32b
# at 4 of 64 layers: 6 steps straight (the CLI's step function and batches,
# no loop, as the reference's tests/test_system.py does), against
# `launch.train.run` for 3 steps with a checkpoint after step 0, the state
# dropped, and `--resume` from that checkpoint to step 6: parameters
# bitwise; the f32_product gradient against the f32 product's. (b)
# rwkv6-7b at 8 of 32 layers: every wkv6_decode and wkv6_decode_backward
# call of the training steps against its plain version, one layer's
# recurrence gradient through WKV6Sequence against autograd through the
# plain steps, then steps timed without the checks. (c) hubert-xlarge
# uncut (48 layers) on SyntheticAudioSource: a finite, falling loss.
# Every cell at batch 8, seq 128; the LM cells at correlation 0.9.
TRAIN_LAYERS = {"qwen3-32b": 4, "rwkv6-7b": 8, "hubert-xlarge": 48}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CORR, TRAIN_SEED = 8, 128, 0.9, 0
TRAIN_STEPS = 6          # every cell's run; the checkpointed run stops at 3
TRAIN_KILL_AT = 3
# the loop checkpoints at every step % TRAIN_CKPT_EVERY == 0: after step 0
# only, in both halves of the pair. One checkpoint of qwen3 at 4 layers is
# 27.3 GB of npz, and a call may write 45 GiB to its machine's disk in all
TRAIN_CKPT_EVERY = TRAIN_STEPS
HUBERT_LR = 1e-3
# wkv6_decode_backward against its plain version: S̄ bitwise (two products
# and a sum, rounded apart in both); r̄, k̄, v̄, w̄, ū are sums of dk or dv
# products taken in another order: within atol + rtol·(the same sum of
# |terms|), as the forward's readout
WKVB_ATOL, WKVB_RTOL = 1e-5, 1e-5
# one layer's recurrence gradient, WKV6Sequence against autograd through
# the plain steps: 128-step chains of such sums; each input's gradient
# within this share of its largest entry
SEQ_GRAD_REL = 1e-4
# the f32_product gradient (the f32 cotangent as two bf16 halves: 2^-16 of
# it kept) against the f32 product's, each rounded once to bf16
F32P_REL, F32P_ROUND = 2.0 ** -15, 2.0 ** -8


def train_cfg(name: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=TRAIN_LAYERS[name])


def train_argv(arch: str, steps: int, ckpt_dir, *extra) -> list:
    return ["--arch", arch, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--correlation",
            str(TRAIN_CORR), "--seed", str(TRAIN_SEED), "--ckpt-dir",
            str(ckpt_dir), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--log-every", "1", *extra]


def wkvb_terms(mod, r, k, v, w, u, state, g_out, g_state):
    """The scale of each backward output's rounding error: the plain
    backward on the inputs' absolute values bounds the sum of |terms| of
    r̄, k̄, v̄, w̄ and ū."""
    return mod.wkv6_decode_backward_torch(
        r.abs(), k.abs(), v.abs(), w, u.abs(), state.abs(), g_out.abs(),
        g_state.abs())[:5]


def wkvb_check(got, got_s, want, want_s, terms, what) -> float:
    """S̄ bitwise; the others within WKVB_ATOL + WKVB_RTOL·Σ|terms|.
    Returns the largest error of r̄, k̄, v̄, w̄, ū."""
    if not torch.equal(got_s, want_s):
        fail(f"{what}: wkv6_decode_backward S̄ differs from its plain "
             "version")
    err = 0.0
    for name, g, w_, sc in zip("rkvwu", got, want, terms):
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: non-finite wkv6_decode_backward {name}̄")
        e = (g - w_).abs()
        if bool((e > WKVB_ATOL + WKVB_RTOL * sc).any()):
            fail(f"{what}: wkv6_decode_backward {name}̄ disagrees with its "
                 f"plain version: max err {float(e.max()):.3e}")
        err = max(err, float(e.max()))
    return err


class TrainCheck:
    """Holds every wkv6 step of a training run against its plain version
    on that call's inputs: the forward steps (out within the forward's
    tolerance, S' bitwise) and the backward steps (`wkvb_check`).
    `WKV6Sequence` calls the two wrappers of `kernels.wkv6_decode` by name,
    so they are swapped for checking ones while the run lasts; the plain
    versions launch no kernel."""

    NAMES = ("wkv6_decode", "wkv6_decode_backward")

    def __init__(self, mod):
        self.mod = mod
        self.orig = {n: getattr(mod, n) for n in self.NAMES}
        self.checked = {n: 0 for n in self.NAMES}
        self.max_err = {n: 0.0 for n in self.NAMES}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.mod, n, getattr(self, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)

    def _note(self, name, err):
        self.checked[name] += 1
        self.max_err[name] = max(self.max_err[name], err)

    def wkv6_decode(self, r, k, v, w, u, state, state_out=None):
        before = state.clone() if state_out is None else state
        out, dest = self.orig["wkv6_decode"](r, k, v, w, u, state, state_out)
        want_o, want_s = self.mod.wkv6_decode_torch(r, k, v, w, u, before)
        err, _ = wkv_check(out, dest, want_o, want_s,
                           wkv_terms(r, k, v, u, before), "train path")
        self._note("wkv6_decode", err)
        return out, dest

    def wkv6_decode_backward(self, r, k, v, w, u, state, g_out, g_state):
        g0 = g_state.clone()
        got = self.orig["wkv6_decode_backward"](r, k, v, w, u, state, g_out,
                                                g_state)
        *want, want_s = self.mod.wkv6_decode_backward_torch(
            r, k, v, w, u, state, g_out, g0)
        terms = wkvb_terms(self.mod, r, k, v, w, u, state, g_out, g0)
        self._note("wkv6_decode_backward", wkvb_check(
            got, g_state, want, want_s, terms, "train path"))
        return got


def n_params(params) -> int:
    return sum(t.numel() for t in tensor_leaves(params).values())


def train_batches(cfg, dev):
    """The CLI's batches (`launch.train.run`'s batch_fn) of `cfg`."""
    from repro_torch.data import make_source
    from repro_torch.launch.specs import ShapeCell

    src = make_source(cfg, ShapeCell("cli", "train", TRAIN_SEQ, TRAIN_BATCH),
                      seed=TRAIN_SEED, correlation=TRAIN_CORR)
    return lambda i: {k: torch.from_numpy(v).to(dev)
                      for k, v in src.batch(i).items()}


def timed_steps(label, cfg, dev, *, steps=TRAIN_STEPS, check=None,
                falling=True, lr=3e-4) -> dict:
    """`steps` train steps of `cfg` (the CLI's optimizer at `lr`, schedule
    and batches) from init, each timed on the host clock around synchronize;
    under `check` (a context manager) if given. Returns the run's losses,
    step ms (after the first), launches, peak memory and final state."""
    from repro_torch.kernels import backend
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, TRAIN_SEED, device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=lr), total_steps=steps,
                           warmup_steps=max(steps // 20, 1))
    batch = train_batches(cfg, dev)
    losses, ms = [], []
    backend.reset_launches()
    with (check or contextlib.nullcontext()):
        for i in range(steps):
            b = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
    counts = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite training loss {losses}")
    if falling and not losses[-1] < losses[0]:
        fail(f"{label}: training loss did not fall: {losses}")
    n = n_params(state["params"])
    step_ms = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n * tokens / (step_ms / 1e3 * BF16_FLOPS)
    print(f"{label}: {n / 1e9:.3f} B parameters; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {step_ms:.1f} ms (median of steps 1-{steps - 1}; step 0 "
          f"{ms[0]:.1f} ms), {tokens / (step_ms / 1e3):.0f} tokens/s, "
          f"model-FLOPs share {mfu:.1%}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {dict((k, v) for k, v in counts.items() if v)}")
    return {"losses": losses, "step_ms": step_ms, "step_ms_all": ms,
            "tokens_per_s": tokens / (step_ms / 1e3), "params": n,
            "mfu": mfu, "peak_gib": peak / 2 ** 30, "launches": counts,
            "state": state, "step": step, "batch": batch}


def f32_product_grad_check(params, dev) -> dict:
    """ops.f32_product's gradient (bf16 operands, f32 result: the chunked
    cross-entropy's product) against autograd of the f32 product of the
    same values, at the loss's shapes: a 1024-token chunk of normed hidden
    states against the first 32768 columns of qwen3's tied head."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    d = params["embed"].shape[1]
    a = torch.randn((TRAIN_BATCH * TRAIN_SEQ, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    b = params["embed"][:32768].T.detach().to(torch.bfloat16)
    cot = torch.randn((a.shape[0], b.shape[1]), generator=gen, device=dev)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = ops.f32_product(a1, b1)
    if out.dtype != torch.float32 or out.grad_fn is None:
        fail(f"f32_product: result {out.dtype}, grad_fn {out.grad_fn}")
    ga, gb = torch.autograd.grad((out * cot).sum(), (a1, b1))
    a2, b2 = (x.float().requires_grad_(True) for x in (a, b))
    wa, wb = torch.autograd.grad(((a2 @ b2) * cot).sum(), (a2, b2))
    errs = {}
    for name, got, want in (("a", ga, wa), ("b", gb, wb)):
        if got.dtype != torch.bfloat16:
            fail(f"f32_product gradient of {name} is {got.dtype}")
        e = (got.float() - want).abs()
        tol = F32P_REL * want.abs().max() + F32P_ROUND * want.abs()
        if bool((e > tol).any()):
            fail(f"f32_product gradient of {name} disagrees with the f32 "
                 f"product's: max err {float(e.max()):.3e}")
        errs[name] = float((e / want.abs().max()).max())
    print(f"f32_product gradient [{a.shape[0]},{d}]x[{d},{b.shape[1]}] bf16 "
          f"against the f32 product's: max err / max|g| a {errs['a']:.2e}, "
          f"b {errs['b']:.2e} (within 2^-15·max|g| + 2^-8·|g|)")
    return errs


def resume_pair(cfg, dev, straight) -> dict:
    """(a): `launch.train.run` for TRAIN_KILL_AT steps (its ResilientLoop
    checkpoints after step 0), the state dropped, then `--resume` to step
    TRAIN_STEPS: parameters bitwise the straight run's."""
    from repro_torch.kernels import backend
    from repro_torch.launch import train as tcli

    parse = tcli.build_parser().parse_args
    ckdir = pathlib.Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        backend.reset_launches()
        res = tcli.run(cfg, parse(train_argv(
            cfg.name, TRAIN_KILL_AT, ckdir, "--device", dev.type)),
            total_steps=TRAIN_STEPS)
        t_first = time.perf_counter() - t0
        marks = sorted(p.name for p in ckdir.glob("*.COMPLETE"))
        ck_bytes = sum(p.stat().st_size for p in ckdir.rglob("*.npz"))
        del res                                   # the process "dies"
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = tcli.run(cfg, parse(train_argv(
            cfg.name, TRAIN_STEPS - 1, ckdir, "--device", dev.type,
            "--resume")), total_steps=TRAIN_STEPS)
        t_resume = time.perf_counter() - t0
        counts = backend.launch_counts()
        if res["start"] != 1 or int(res["state"]["opt"]["step"]) != \
                TRAIN_STEPS:
            fail(f"resume started at {res['start']} and ended at step "
                 f"{int(res['state']['opt']['step'])}")
        got = {k: v.to("cpu", copy=True) for k, v in
               tensor_leaves(res["state"]["params"]).items()}
        differ = [k for k, v in straight.items() if not torch.equal(v, got[k])]
        print(f"qwen3 resume pair: run of {TRAIN_KILL_AT} steps under "
              f"ResilientLoop ({marks}; {ck_bytes / 1e9:.2f} GB of npz) "
              f"{t_first:.1f} s, resumed at step {res['start']} to "
              f"{TRAIN_STEPS} {t_resume:.1f} s; parameters bitwise the "
              f"straight run's: {not differ} ({len(differ)} of "
              f"{len(straight)} leaves differ{': ' + ', '.join(differ) if differ else ''})")
        if differ:
            fail("the resumed run's parameters are not bitwise the straight "
                 f"run's: {differ}")
        return {"ckpt_gb": ck_bytes / 1e9, "first_s": t_first,
                "resume_s": t_resume, "markers": marks,
                "resumed_losses": res["losses"], "launches": counts}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def wkv_layer_grad_check(cfg, dev) -> dict:
    """(b): the inputs of layer 0's WKV6Sequence in one training forward,
    then its gradients (r, k, v, w, u, s0) under a random cotangent against
    autograd through the plain steps (`wkv6_decode_torch`) on the card."""
    from repro_torch.kernels import wkv6_decode as wmod
    from repro_torch.models import init_params
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.train import loss_fn

    captured = []
    orig = ssm_mod.WKV6Sequence

    class Recording:
        @staticmethod
        def apply(*args):
            if not captured:
                captured.extend(a.detach().clone() for a in args)
            return orig.apply(*args)

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    params = init_params(cfg1, TRAIN_SEED, device=dev)
    ssm_mod.WKV6Sequence = Recording
    try:
        with torch.no_grad():
            loss_fn(params, cfg1, train_batches(cfg, dev)(0))
    finally:
        ssm_mod.WKV6Sequence = orig
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    b, s, h, dk = captured[0].shape
    g_out = torch.randn((b, s, h, dk), generator=gen, device=dev)
    ka = [x.clone().requires_grad_(True) for x in captured]
    out, _ = wmod.WKV6Sequence.apply(*ka)
    got = torch.autograd.grad((out * g_out).sum(), ka)
    pa = [x.clone().requires_grad_(True) for x in captured]
    st, outs = pa[5], []
    for t in range(s):
        o, st = wmod.wkv6_decode_torch(pa[0][:, t], pa[1][:, t], pa[2][:, t],
                                       pa[3][:, t], pa[4], st)
        outs.append(o)
    want = torch.autograd.grad((torch.stack(outs, 1) * g_out).sum(), pa)
    errs = {}
    for name, g, w in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        e = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not bool(torch.isfinite(g).all()) or e > SEQ_GRAD_REL * scale:
            fail(f"WKV6Sequence gradient of {name} disagrees with autograd "
                 f"through the plain steps: max err {e:.3e} (max |g| "
                 f"{scale:.3e})")
        errs[name] = e / max(scale, 1e-30)
    print(f"WKV6Sequence, layer 0 of rwkv6 ([{b},{s},{h},{dk}], w in "
          f"[{float(captured[3].min()):.4f}, {float(captured[3].max()):.4f}])"
          f": gradients against autograd through the plain steps, max err / "
          f"max|g|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def wkvb_timing(dev, results, max_err) -> None:
    """wkv6_decode_backward at rwkv6-7b's [8, 64, 64] x 64 x 64 against its
    plain version: three input cases checked (w near 1 in the third), then
    timed beside its bound."""
    from repro_torch.kernels import wkv6_decode as wmod

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    shape = (WKV_B, WKV_H, WKV_D)
    for case in range(3):
        r, k, v, go = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        w = torch.rand(shape, generator=gen, device=dev)
        w = 1.0 - w * 0.01 if case == 2 else w * 0.9 + 0.05
        u = torch.randn((WKV_H, WKV_D), generator=gen, device=dev)
        st, gs = (torch.randn((*shape, WKV_D), generator=gen, device=dev)
                  * (1 + 10 * case) for _ in range(2))
        g0 = gs.clone()
        got = wmod.wkv6_decode_backward(r, k, v, w, u, st, go, gs)
        *want, want_s = wmod.wkv6_decode_backward_torch(r, k, v, w, u, st,
                                                        go, g0)
        err = wkvb_check(got, gs, want, want_s,
                         wkvb_terms(wmod, r, k, v, w, u, st, go, g0),
                         "wkv6_decode_backward")
        max_err["wkv6_decode_backward"] = max(
            max_err["wkv6_decode_backward"], err)
    t_rep = time_ms(lambda: wmod.wkv6_decode_backward(r, k, v, w, u, st, go,
                                                      gs))
    t_p = time_ms(lambda: wmod.wkv6_decode_backward_torch(
        r, k, v, w, u, st, go, gs), iters=5)
    t_e = time_ms(lambda: wmod.wkv6_decode_backward(r, k, v, w, u, st, go,
                                                    gs), graph=False)
    # as WKV6Sequence's backward runs it: t = S-1 ... 0 over S distinct
    # state slabs of one buffer (1.08 GB at S = 128), each read from HBM,
    # against one Ḡ carried in place; a repeated call on one input finds its
    # 26.5 MB in the 50 MB L2
    s_len = TRAIN_SEQ
    seq = [torch.randn((s_len, *shape), generator=gen, device=dev)
           for _ in range(4)]
    ws = torch.rand((s_len, *shape), generator=gen, device=dev) * 0.1 + 0.9
    states = torch.randn((s_len + 1, *shape, WKV_D), generator=gen,
                         device=dev)

    def backward_loop():
        for t in range(s_len - 1, -1, -1):
            wmod.wkv6_decode_backward(seq[0][t], seq[1][t], seq[2][t], ws[t],
                                      u, states[t], seq[3][t], gs)

    t_k = time_ms(backward_loop, iters=2) / s_len
    del seq, ws, states
    # S and Ḡ read, S̄ written; r, k, w, v, ḡo read once, u once; r̄, k̄, w̄,
    # ū, v̄ written; ~16 f32 operations per state element
    byts = 4 * (3 * st.numel() + 10 * r.numel() + u.numel())
    flops = 16 * st.numel()
    bound = max(byts / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    print(f"wkv6_decode_backward [{WKV_B},{WKV_H},{WKV_D}] x {WKV_D}x{WKV_D}:"
          f" three cases S̄ bitwise, the rest within atol {WKVB_ATOL} + rtol "
          f"{WKVB_RTOL}·Σ|terms| (max err "
          f"{max_err['wkv6_decode_backward']:.3e}); {t_k:.4f} ms a step of "
          f"the {s_len}-step backward loop (one call repeated on one input, "
          f"L2-resident: {t_rep:.4f}; eager call {t_e:.4f}) bound "
          f"{bound:.6f} ({byts / 1e6:.1f} MB) plain {t_p:.4f}; library: none "
          "(no single PyTorch call computes the step's gradient)")
    results["wkv6_decode_backward"] = {
        "shape": f"[{WKV_B},{WKV_H},{WKV_D}] f32, {WKV_D}x{WKV_D} state",
        "ms": t_k, "ms_repeated_call": t_rep, "plain_ms": t_p,
        "bound_ms": bound, "bound_by": (
            "bytes" if byts / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations"), "library_ms": None,
    }


def train_phase(dev, results, max_err) -> tuple[dict, dict]:
    """Phase 16. Returns ({cell: its JSON}, {run: launch counts})."""
    from repro_torch.kernels import wkv6_decode as wmod

    out, launches = {}, {}
    wkvb_timing(dev, results, max_err)

    # (a) qwen3-32b, 4 layers: the straight run, then the resume pair
    cfg = train_cfg("qwen3-32b")
    run = timed_steps(f"qwen3-32b {cfg.n_layers} layers, straight run",
                      cfg, dev)
    straight = {k: v.to("cpu", copy=True) for k, v in
                tensor_leaves(run["state"]["params"]).items()}
    launches["qwen3 straight"] = run["launches"]
    out["qwen3"] = {k: v for k, v in run.items()
                    if k not in ("state", "step", "batch", "launches")}
    out["qwen3"]["f32_product_grad"] = f32_product_grad_check(
        run["state"]["params"], dev)
    st, step, batch = run["state"], run["step"], run["batch"]
    wall, busy, _ = profile_step(lambda: step(st, batch(TRAIN_STEPS)),
                                 "one qwen3 train step", grad=True)
    out["qwen3"]["busy_share"] = busy / wall
    del run, st, step
    pair = resume_pair(cfg, dev, straight)
    launches["qwen3 train.run + resume"] = pair.pop("launches")
    out["qwen3"]["resume"] = pair
    del straight

    # (b) rwkv6-7b, 8 layers: checked steps, the layer gradient, timed steps
    cfg = train_cfg("rwkv6-7b")
    with TrainCheck(wmod) as chk:
        run = timed_steps(f"rwkv6-7b {cfg.n_layers} layers, every wkv6 call "
                          "checked", cfg, dev, steps=2, check=chk,
                          falling=False)
    need = run["launches"]
    for kn in ("wkv6_decode", "wkv6_decode_backward"):
        if chk.checked[kn] != need[kn] or need[kn] <= 0:
            fail(f"train path: {chk.checked[kn]} {kn} calls checked of "
                 f"{need[kn]} launched")
        max_err[kn] = max(max_err[kn], chk.max_err[kn])
    print(f"rwkv6 checked steps: {chk.checked['wkv6_decode']} wkv6_decode "
          f"calls (max err {chk.max_err['wkv6_decode']:.3e}) and "
          f"{chk.checked['wkv6_decode_backward']} wkv6_decode_backward "
          f"calls (max err {chk.max_err['wkv6_decode_backward']:.3e}) "
          "against their plain versions")
    launches["rwkv6 checked"] = run["launches"]
    del run
    errs = wkv_layer_grad_check(cfg, dev)
    run = timed_steps(f"rwkv6-7b {cfg.n_layers} layers", cfg, dev)
    launches["rwkv6"] = run["launches"]
    out["rwkv6"] = {k: v for k, v in run.items()
                    if k not in ("state", "step", "batch", "launches")}
    out["rwkv6"]["layer_grad_rel_err"] = errs
    st, step, batch = run["state"], run["step"], run["batch"]
    wall, busy, _ = profile_step(lambda: step(st, batch(TRAIN_STEPS)),
                                 "one rwkv6 train step", grad=True)
    out["rwkv6"]["busy_share"] = busy / wall
    del run, st, step

    # (c) hubert-xlarge, uncut. SyntheticAudioSource draws its labels
    # uniformly, apart from the frames: the loss falls only as the random
    # head learns that marginal, which lr 1e-3 shows within 6 steps
    cfg = train_cfg("hubert-xlarge")
    run = timed_steps(f"hubert-xlarge {cfg.n_layers} layers", cfg, dev,
                      lr=HUBERT_LR)
    launches["hubert"] = run["launches"]
    out["hubert"] = {k: v for k, v in run.items()
                     if k not in ("state", "step", "batch", "launches")}
    st, step, batch = run["state"], run["step"], run["batch"]
    wall, busy, _ = profile_step(lambda: step(st, batch(TRAIN_STEPS)),
                                 "one hubert train step", grad=True)
    out["hubert"]["busy_share"] = busy / wall
    del run, st, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


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
    from repro_torch.kernels.delta_quant import (
        delta_quant,
        delta_quant_torch,
        vector_access,
    )
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
    from repro_torch.serve.compiled_step import summary_line
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
    # delta_quant: every 8-wide vector instance moves x in 16-byte loads;
    # printed per instance: its loads by width and how many of them are
    # issued before the CTA's first barrier (one round trip per thread)
    for fn, body in sass_functions(backend.sass("delta_quant")).items():
        vec, items = re.search(r"delta_quant_kernel.*Li(\d+)ELi(\d+)E",
                               fn).groups()
        head = body.split("BAR.SYNC", 1)[0]
        ldg = re.findall(r"\bLDG\.E\.?(\d+|[US]\d+)?", body)
        stg = re.findall(r"\bSTG\.E\.?(\d+|[US]\d+)?", body)
        if vec == "8" and "128" not in ldg:
            fail(f"delta_quant vector instance {fn} has no 16-byte load")
        width = lambda ws: ", ".join(f"{ws.count(w)}x{w or '32'}"
                                     for w in sorted(set(ws)))
        print(f"delta_quant SASS, VEC {vec} ITEMS {items} ({fn[:60]}...): "
              f"LDG {width(ldg)} ({len(re.findall(r'LDG', head))} before the "
              f"first barrier), STG {width(stg)}")
    print(f"kernel substrate: {backend.describe()}")

    # ------------------------------------------------------------ 3. kernels
    phase("3. kernels against their plain versions")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results: dict[str, dict] = {}
    max_err = {k: 0.0 for k in KERNEL_META}

    # delta_quant: bitwise on q, mask and delta at every serve width (qwen3
    # 5120, 8192, 25600; rwkv6 4096, 14336), skip, tie and scale; then the
    # other tile shapes, dtype pairs and a storage offset that is not 16-byte
    # aligned (the kernel's scalar instance). The rwkv6 widths and the extra
    # cases draw from a generator of their own, so the qwen3 phases see the
    # same inputs whatever is added here.
    def dq_check(x, prev_q, scale, bm, bk, delta_dtype, what):
        got = delta_quant(x, prev_q, scale, block_m=bm, block_k=bk,
                          delta_dtype=delta_dtype)
        want = delta_quant_torch(x, prev_q, scale, block_m=bm, block_k=bk,
                                 delta_dtype=delta_dtype)
        for a, b, part in zip(got, want, ("q", "delta", "mask")):
            if not torch.equal(a, b):
                fail(f"delta_quant {part} differs at {what}")

    def dq_inputs(m, k, bk, skip, scale_v, ties, g, x_dtype=torch.bfloat16):
        x = torch.randn((m, k), generator=g, device=dev) * 2.0
        if ties:  # exact half-way codes exercise round-half-to-even
            half = (torch.randint(-100, 100, (m, k), generator=g,
                                  device=dev) + 0.5) * scale_v
            pick = torch.rand((m, k), generator=g, device=dev) < 0.25
            x = torch.where(pick, half, x)
        x = x.to(x_dtype)
        scale = torch.tensor(scale_v, dtype=torch.float32, device=dev)
        mask = random_mask(1, k // bk, skip, g, dev)
        same = expand(mask, m, bk) == 0
        rand_q = torch.randint(-127, 128, (m, k), generator=g,
                               device=dev).to(torch.int8)
        return x, torch.where(same, quantize_int8(x, scale), rand_q), scale

    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(3)
    dq_widths = sorted({s[1] for s in SITES} | {4096, 14336})
    for k in dq_widths:
        g = gen if any(k == s[1] for s in SITES) else gen_d
        for skip in SKIPS:
            for scale_v, ties in ((0.05, False), (0.0625, True)):
                x, prev_q, scale = dq_inputs(M, k, BK, skip, scale_v, ties, g)
                dq_check(x, prev_q, scale, BM, BK, torch.bfloat16,
                         f"K={k} skip={skip} scale={scale_v}")
    xq = torch.randn((16, 512), generator=gen, device=dev)
    pq = torch.randint(-127, 128, (16, 512), generator=gen,
                       device=dev).to(torch.int8)
    sc = torch.tensor(0.05, device=dev)
    dq_check(xq, pq, sc, 8, 128, torch.float32, "f32 [16,512] block_k 128")
    dq_cases = 0
    for m, k, bm, bk in ((128, 4096, 128, 256), (M, 4096, 8, 64),
                         (M, 14336, 8, 128), (M, 25600, 8, 64)):
        for x_dtype, d_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.bfloat16, torch.float32),
                                 (torch.float32, torch.float32)):
            x, prev_q, scale = dq_inputs(m, k, bk, 0.5, 0.0625, True, gen_d,
                                         x_dtype)
            dq_check(x, prev_q, scale, bm, bk, d_dtype,
                     f"[{m},{k}] block {bm}x{bk} x {x_dtype} delta {d_dtype}")
            dq_cases += 1
    for x_dtype in (torch.bfloat16, torch.float32):
        x, prev_q, scale = dq_inputs(M, 4096, BK, 0.5, 0.0625, True, gen_d,
                                     x_dtype)
        xo = torch.empty(x.numel() + 1, dtype=x_dtype, device=dev)[1:]
        po = torch.empty(x.numel() + 3, dtype=torch.int8, device=dev)[3:]
        xo, po = xo.view(x.shape).copy_(x), po.view(x.shape).copy_(prev_q)
        if vector_access((xo.data_ptr(), po.data_ptr()), BK):
            fail("the offset views took the vector instance")
        dq_check(xo, po, scale, BM, BK, x_dtype,
                 f"unaligned offset views, x {x_dtype}")
        dq_cases += 1
    torch.cuda.synchronize()
    print(f"delta_quant: q, delta and mask bitwise equal at K in "
          f"{set(dq_widths)} x skip {{0, 0.5, 0.78, 1.0}} (+ ties), f32 at "
          f"[16,512], and {dq_cases} cases of block 128x256 / 8x64 / 8x128, "
          "x/delta bf16/bf16, bf16/f32, f32/f32 and unaligned offset views "
          "(the scalar instance)")

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
                                out.data_ptr(), M, k, k, n, n, BM, BK, c,
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
    # delta_quant at every serve width. At these sizes its byte bound is
    # below what a launch costs, so beside the bound it is held against the
    # launch floor: a one-element PyTorch elementwise op in the same graph
    # replay (a yardstick; the port never calls it).
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1))
    print(f"  launch floor (one-element add_, graph replay): {floor:.4f}")
    dq_by_shape = []
    for k in dq_widths:
        g = gen if any(k == s[1] for s in SITES) else gen_d
        x = torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16)
        prev_q = torch.randint(-127, 128, (M, k), generator=g,
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
              f"bound {bound:.6f} floor {floor:.4f} plain {t_p:.4f}")
        dq_by_shape.append({"K": k, "ms": t_k, "bound_ms": bound})
        if k == 25600:
            results["delta_quant"] = {
                "shape": f"[{M},{k}] bf16", "ms": t_k, "plain_ms": t_p,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            }
    results["delta_quant"].update(by_shape=dq_by_shape, floor_ms=floor)

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

    def drive(cfg, argv, *, check=True, after_step=None, log_to=None,
              checker=PathCheck):
        """One serve. With `check`, every kernel call is held against its
        plain version (`checker`, a PathCheck) and the counts of checked
        calls must equal the launches. With `log_to` (a path) the serve's
        output goes there whole, and only its unindented lines are
        printed."""
        args = serve.build_parser().parse_args(argv)
        buf = io.StringIO()
        backend.reset_launches()
        with (checker(ops) if check else contextlib.nullcontext()) as chk, \
                contextlib.redirect_stdout(buf):
            res = serve.run(cfg, args, after_step=after_step)
        torch.cuda.synchronize()
        counts = backend.launch_counts()
        text = buf.getvalue()
        if log_to is None:
            print(text, end="")
        else:
            log_to.write_text(text)
            lines = text.splitlines()
            keep = [ln for ln in lines
                    if not ln.startswith(("  ", "ControlReport"))]
            print("\n".join(keep))
            print(f"({len(lines) - len(keep)} lines of control decisions and "
                  f"per-site detail: {log_to})")
        if check:
            if chk.checked != counts:
                fail(f"kernel calls checked {chk.checked} != launches {counts}")
            for kn, n in chk.checked.items():
                if n:
                    max_err[kn] = max(max_err[kn], chk.max_err[kn])
            print("serve path: every kernel call (each site, layer and decode "
                  "step) held against its plain version on the call's own "
                  "inputs — delta_quant q/delta/mask bitwise, GEMMs within "
                  f"atol {GEMM_ATOL} rtol {GEMM_RTOL}, wkv6 state bitwise and "
                  f"out within atol {WKV_ATOL} + rtol {WKV_RTOL}·Σ|terms|; max "
                  "err " + ", ".join(f"{kn} {chk.max_err[kn]:.3e}"
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
        return res, counts, text

    graph_rows = []

    def serve_pair(cfg, argv, label, hook=None, pairs=5, probe=None,
                   keep=None):
        """The checked serve (`--eager`, every kernel call held against its
        plain version), then the graph serve on the same seed and traffic.
        Tokens, SensorReport lines, launch counts, mode mirrors and every
        tensor of the final reuse cache and decode state must be equal.
        Prints the graph serve's variants, captures, capture seconds and
        pools, the step time both ways and one profiled eager step and
        replay; then `probe(step)` if given, on the graph serve's step.
        With `keep` (a dict), the graph serve's outcome and output text go
        into it. Returns (launch counts, the hook logs of both serves)."""
        hooks = [hook() if hook else (None, None) for _ in range(2)]
        print(f"--- {label}: checked serve, --eager")
        res, counts_e, text = drive(cfg, argv + ["--eager"],
                                    after_step=hooks[0][0])
        want = outcome(res, text)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        print(f"--- {label}: graph serve")
        res, counts_g, text = drive(cfg, argv, check=False,
                                    after_step=hooks[1][0])
        got = outcome(res, text)
        step = res["step"]
        for part in ("tokens", "reports", "modes"):
            if got[part] != want[part]:
                fail(f"{label}: the graph serve's {part} differ from the "
                     "eager serve's")
        if counts_g != counts_e:
            fail(f"{label}: graph serve launches {counts_g} != eager "
                 f"{counts_e}")
        diff = [k for k, t in want["tensors"].items()
                if not torch.equal(t, got["tensors"][k])]
        if diff:
            fail(f"{label}: final reuse cache / decode state differ at "
                 f"{diff[:8]} ({len(diff)} tensors)")
        if hook and hooks[0][1]["seq"] != hooks[1][1]["seq"]:
            fail(f"{label}: the decode keys differ between the serves")
        summ = step.summary()
        print(f"{label}: graph serve equal to the checked eager serve — "
              f"tokens of {len(got['tokens'])} requests, "
              f"{len(got['reports'])} SensorReport lines, launch counts, and "
              f"{len(got['tensors'])} tensors of the final reuse cache and "
              "decode state bitwise")
        print(f"{label}: {summary_line(summ)}")
        for key, v in step.variants.items():
            print(f"  {key[0]} variant: capture {v.seconds:.3f} s, pool "
                  f"{v.pool_bytes / 1e6:.1f} MB, "
                  f"{sum(v.launches.values())} kernel launches a replay")
        if keep is not None:
            keep.update(got, text=text, counts=counts_g)
        del want, got
        eager, graph = step_times(step, pairs)
        med_e, med_g = statistics.median(eager), statistics.median(graph)
        print(f"{label}: decode step (host clock around synchronize, "
              f"{pairs} each in turns): eager median {med_e:.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in eager)}), graph replay median "
              f"{med_g:.2f} ms ({', '.join(f'{t:.2f}' for t in graph)}); "
              f"{med_e / med_g:.2f}x")
        wall_e, busy_e, rows_e = profile_step(
            step.run_decode, f"{label}: one eager decode step")
        wall_g, busy_g, rows_g = profile_step(
            lambda: step.decode(step.tokens), f"{label}: one graph replay")
        # the profiler slows the host and each traced kernel, so the idle
        # share is also read against the unprofiled median step time; the
        # busy time comes from the profiled run and can exceed it slightly,
        # so that share is clamped at 0
        idle_e, idle_g = (max(0.0, 1 - b / m)
                          for b, m in ((busy_e, med_e), (busy_g, med_g)))
        print(f"{label}: device busy (profiled) against the unprofiled "
              f"median step: eager {busy_e:.2f} of {med_e:.2f} ms (idle "
              f"{idle_e:.1%}), graph replay {busy_g:.2f} of {med_g:.2f} ms "
              f"(idle {idle_g:.1%})")
        graph_rows.append({
            "serve": label, "eager_ms": med_e, "graph_ms": med_g,
            "variants": summ["variants"], "captures": summ["captures"],
            "capture_s": summ["capture_s"], "pool_mb": summ["pool_bytes"] / 1e6,
            "busy_eager_ms": busy_e, "busy_graph_ms": busy_g,
            "idle_eager": idle_e, "idle_graph": idle_g,
            "idle_eager_profiled": 1 - busy_e / wall_e,
            "idle_graph_profiled": 1 - busy_g / wall_g,
            "kernels_eager": sum(e.count for e in rows_e),
            "kernels_graph": sum(e.count for e in rows_g)})
        if probe is not None:
            probe(step)
        del res, step
        gc.collect()
        torch.cuda.empty_cache()
        return counts_e, [h[1] for h in hooks]

    # phase 4's graph serve, which phase 14a's sharded serve must equal
    unsharded = {"qwen3-32b": {}, "qwen2-72b": {}}
    launches_default, _ = serve_pair(cfg, serve_argv, "qwen3 default",
                                     keep=unsharded["qwen3-32b"])
    unsharded["qwen3-32b"]["row"] = graph_rows[-1]
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
        launches_ragged, _ = serve_pair(
            cfg, serve_argv + ["--tuned-policy", table], "qwen3 ragged")
    if launches_ragged["reuse_matmul_ragged"] <= 0:
        fail("reuse_matmul_ragged was not launched on the ragged serve path")

    # ------------------------------------------------- 5b. refresh, recapture
    phase("5b. serve with --refresh-every 2 (mode and exec flips recapture)")
    _, logs = serve_pair(cfg, serve_argv + ["--refresh-every", "2"],
                         "qwen3 refresh", hook=flip_hook)
    seq = logs[1]["seq"]
    print(f"decode keys after each step (step, key index, variant exists): "
          f"{seq}")
    moved = [j for j in range(1, len(seq)) if seq[j][1] != seq[j - 1][1]]
    if all(known for _, _, known in seq):
        fail("the refresh serve never recaptured after a flip")
    traffic = any(seq[j][0] % 2 == 0 for j in moved)
    reused = any(seq[j][2] for j in moved)
    print(f"recaptured after a flip: yes; a flip back to a known key "
          f"replayed its variant: {'yes' if reused else 'no'}; the policy "
          f"refresh itself flipped: {'yes' if traffic else 'no'}")
    if not (traffic or reused):
        fail("the forced flip back did not replay the known variant")

    # ------------------------------------------------------------- 6. rwkv6
    # uncut: all 32 layers, 15.1 GB of bf16 weights
    rcfg = get_config("rwkv6-7b")
    phase(f"6. serve, rwkv6-7b (full width, {rcfg.n_layers} layers)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches_rwkv, _ = serve_pair(rcfg, [
        "--arch", "rwkv6-7b", "--reuse", "--batch-slots", "8", "--requests",
        "8", "--prompt-len", "32", "--cache-len", "128", "--max-new", "8"],
        "rwkv6", pairs=3)
    print(f"rwkv6 serves: {time.perf_counter() - t0:.1f} s (checked eager, "
          f"graph, timing and profiles); peak device memory "
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

    # ------------------------------- 8. measured decode and the tuning loop
    phase("8. measured decode on correlated traffic and the tuning loop")
    launches_measured = measured_decode_phase(cfg, rcfg, dev, graph_rows,
                                              max_err)

    # --------------------------------------------- 9. the online control plane
    phase("9. the online control plane (closed loop; the serve with control)")
    launches_control = control_loop_phase(cfg, rcfg, dev, max_err)
    control_serve, counts = control_serve_phase(
        cfg, serve_argv, drive, root / "chiprun_out" / "chip_smoke")
    launches_control["qwen3 serve --control-every 2"] = counts
    control_serve["basic_product_ms"] = basic_product_timing(dev, gen)
    print(json.dumps({"control_serve": control_serve}))

    # ---------------------------------------------------- 10. the guard plane
    phase("10. the guard plane (chaos at mlp_in; the guarded serve)")
    chaos, counts = chaos_phase(dev, max_err)
    launches_guard = {"chaos (graph run)": counts}
    guard_serve, counts = guard_serve_phase(
        cfg, serve_argv, drive, root / "chiprun_out" / "chip_smoke")
    launches_guard.update(counts)
    interval_cost = interval_cost_phase(
        cfg, serve_argv, drive, root / "chiprun_out" / "chip_smoke")
    print(json.dumps({"guard": {"chaos": chaos, "serve": guard_serve,
                                "interval_cost": interval_cost}}))

    # --------------------------------------- 11. the observability plane
    phase("11. the observability plane (obs serve, measured pricing, "
          "profile, fleet)")
    logdir = root / "chiprun_out" / "chip_smoke"
    obs, launches_obs, table_path = obs_serve_phase(
        cfg, serve_argv, drive, dev, max_err, results, logdir)
    label = "qwen3 serve --control-every 2 --latency-table"
    priced, counts = control_serve_phase(
        cfg, serve_argv + ["--latency-table", str(table_path)], drive,
        logdir, label=label, log="phase11b")
    launches_obs["priced serve (eager, checked)"] = counts
    lanes = {(s, i): (m, priced["layer_modes"][s][i])
             for s, modes in control_serve["layer_modes"].items()
             for i, m in enumerate(modes)}
    demoted = sorted(f"{s}@{i}" for (s, i), (a, b) in lanes.items()
                     if a == "reuse" and b == "basic")
    print(f"{label}: against phase 9b's constant pricing, "
          f"{len(demoted)} of {len(lanes)} lanes demoted to basic "
          f"{demoted or ''}; decisions {priced['decisions']} (9b: "
          f"{control_serve['decisions']})")
    priced["demoted_vs_9b"] = demoted
    obs["priced_serve"] = priced
    obs["profile"] = profile_phase(cfg, serve_argv, drive, logdir)
    fleet, counts = fleet_phase(cfg, logdir)
    launches_obs.update(counts)
    print(json.dumps({"obs": obs, "fleet": fleet}))

    # ------------------------------------ 12. the MoE family and compact
    phase("12. the MoE family (mixtral-8x7b, llama4-scout) and the compact "
          "path")
    from repro_torch.models import init_params

    launches_moe = moe_serve_phase(serve_pair, graph_rows)
    mcfg = moe_cfg("mixtral-8x7b")
    gc.collect()
    torch.cuda.empty_cache()
    mparams = init_params(mcfg, MEASURED_SEED, device=dev)
    moe = {}
    moe["runner"], counts = moe_runner_phase(mparams, mcfg, dev, max_err)
    launches_moe.update(counts)
    moe["window"] = window_phase(mparams, dev)
    moe["expert_reuse"] = expert_reuse_phase(mparams, dev)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    qparams = init_params(cfg, MEASURED_SEED, device=dev)
    moe["compact"], counts = compact_phase(cfg, qparams, serve_pair,
                                           serve_argv, dev, max_err)
    launches_moe.update(counts)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"moe": moe}))

    # ---------------------------------- 13. the remaining archetypes
    phase("13. the remaining decoder archetypes (zamba2, gemma3, qwen2-72b, "
          "nemotron-4-15b, qwen2-vl-7b) and the LM head")
    archetypes, launches_arch = archetype_serve_phase(
        serve_pair, graph_rows, keep=unsharded["qwen2-72b"])
    gc.collect()
    torch.cuda.empty_cache()
    archetypes["mamba"] = mamba_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    archetypes["local_window"] = local_window_phase(dev)
    archetypes["lm_head"] = head_phase(dev)
    archetypes["seconds"] = time.perf_counter() - _PHASE["t0"]
    print(json.dumps({"archetypes": archetypes}))

    # ---------------------------------------- 14. sharded reuse serving
    phase("14. sharded reuse serving (serve --mesh host:4: qwen3-32b, "
          "qwen2-72b; the controlled serve)")
    sharded, launches_sharded = sharded_phase(serve_pair, graph_rows,
                                              unsharded, dev)
    sharded["control"] = sharded_control_phase(
        cfg, serve_argv, drive, root / "chiprun_out" / "chip_smoke")
    sharded["seconds"] = time.perf_counter() - _PHASE["t0"]
    print(json.dumps({"sharded": sharded}))

    # ------------------------ 15. checkpointing and the int8 KV cache
    phase("15. checkpointing, cache restore and the int8 KV cache "
          "(qwen3-32b 8 layers)")
    ckpt, launches_ckpt = ckpt_phase(cfg, serve_argv, drive,
                                     root / "chiprun_out" / "chip_smoke")
    ckpt["kv_quant"], counts = kv_quant_phase(cfg, serve_argv, serve_pair,
                                              graph_rows, dev)
    launches_ckpt.update(counts)
    ckpt["seconds"] = time.perf_counter() - _PHASE["t0"]
    print(json.dumps({"ckpt": ckpt}))

    # ------------------------------------------------------- 16. training
    phase("16. training (qwen3-32b 4 layers with the resume pair, rwkv6-7b "
          "8 layers, hubert-xlarge uncut)")
    train, launches_train = train_phase(dev, results, max_err)
    for kn, run in (("wkv6_decode", "rwkv6"),
                    ("wkv6_decode_backward", "rwkv6")):
        if launches_train[run][kn] <= 0:
            fail(f"{kn} was not launched on the rwkv6 training path")
    train["seconds"] = time.perf_counter() - _PHASE["t0"]
    print(json.dumps({"train": train}))

    kernels = []
    path_launches = {"reuse_matmul_ragged": launches_ragged,
                     "wkv6_decode": launches_rwkv,
                     "reuse_matmul_int8": launches_int8,
                     "wkv6_decode_backward": launches_train["rwkv6"]}
    for kn, (src, replaces) in KERNEL_META.items():
        r = results[kn]
        launches = path_launches.get(kn, launches_default)[kn]
        kernels.append({"name": kn, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": max_err[kn], **r,
                        "launches_measured_decode": {
                            run: c[kn] for run, c in launches_measured.items()},
                        "launches_control": {
                            run: c[kn] for run, c in launches_control.items()},
                        "launches_guard": {
                            run: c[kn] for run, c in launches_guard.items()},
                        "launches_obs": {
                            run: c[kn] for run, c in launches_obs.items()},
                        "launches_moe": {
                            run: c[kn] for run, c in launches_moe.items()},
                        "launches_archetypes": {
                            run: c[kn] for run, c in launches_arch.items()},
                        "launches_sharded": {
                            run: c[kn] for run, c in launches_sharded.items()},
                        "launches_ckpt": {
                            run: c[kn] for run, c in launches_ckpt.items()},
                        "launches_train": {
                            run: c[kn] for run, c in launches_train.items()}})
    print(json.dumps({"graph_serves": graph_rows}))
    phase(None)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
