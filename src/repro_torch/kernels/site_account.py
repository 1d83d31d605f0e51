"""A reuse site call's cache bookkeeping, as one launch.

    matches[m] = #{k : cur_q[m, k] == prev_q[m, k]}      then prev_q ← cur_q
    sim_ema[m] = fma(sim_ema[m], f32(decay), matches[m] · c),
                 c = f32(1 − decay) · f32(1/K)
    steps += 1; the ctrl occupancy, the EMA of Σ mask over gm·gk (reuse)
    the sensor counters of `sensor.counters.update_on_reuse` /
    `update_on_basic`, with the dma, grid-step and overflow accounting of
    the call's exec path, and the ownership partition of a sharded call

The reference computes these lanes in the jitted step that runs its kernels
(`src/repro/core/reuse_linear.py:222-264`, `src/repro/sensor/counters.py:
151-281`), where XLA fuses them; eagerly they are about a hundred small
kernels a site call. Two entries, each one kernel on CUDA tensors:

- `delta_quant_account` (reuse mode): quantize → delta → tile mask and the
  bookkeeping in one pass over the call's own x and prev_q, the fused
  instance of `csrc/delta_quant.cu` (the codes land in prev_q; the last CTA
  writes every other lane). Its plain version is `delta_quant_torch` on
  zero-padded operands followed by `site_account_torch`.
- `site_account` (basic mode, or any caller that holds the codes):
  `csrc/site_account.cu`, a row pass whose last CTA writes the lanes.

Both take their plain versions on CPU tensors. Every lane is updated in
place, in the cache entry's own tensors (a CUDA graph reads them), and is
bitwise the plain version's: the kernels round once where `fma_f32` does
and twice where the plain version multiplies and then adds
(`csrc/site_account.cuh`). NaN lanes stay NaN in the same positions; their
payloads may differ (the card's FMA returns the canonical NaN).

The accounting functions (`clamp_budget`, `ragged_dma_tiles`,
`ragged_grid_steps`, `budget_overflow`; `weight_dma_tiles` lives with the
block-skip kernel) are the reference's, ported exactly, and
`kernels/ops.py` exports them. They stay on the tensor's device
(`torch.where`), so no Python branch reads a CUDA tensor. The ragged ones
read the budget as an int32 device scalar clamped to [1, gk] (the engine's
budget lane, or a Python int made into one); with kb = gk no row overflows,
so one formula gives both of the reference's branches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.similarity import ema_update_mean, row_code_matches
from repro_torch.kernels import backend
from repro_torch.kernels.delta_quant import delta_quant_torch
from repro_torch.kernels.reuse_matmul import weight_dma_tiles
from repro_torch.sensor.counters import (
    ShardCtx,
    owned_k_count,
    owned_panel_count,
    update_on_basic,
    update_on_reuse,
)

# csrc/site_account.cu kChunk: the bytes of a row that one CTA of its row
# pass compares
CHUNK = 4096
PATHS = ("kernel", "dense", "ragged", "compact")  # the kernel's path codes
# the sensor lanes the kernel writes, in the order of its Lanes struct
SENSOR_LANES = (
    "skipped_tiles", "computed_tiles", "skipped_macs", "computed_macs",
    "skipped_weight_bytes", "total_weight_bytes", "reused_out_elems",
    "dma_issued_tiles", "grid_steps", "overflow_fallbacks", "mode_flag",
    "mode_transitions", "slot_hit_sum", "slot_steps",
)


def clamp_budget(max_active_k: int | None, gk: int) -> int:
    """Static k-extent budget, clamped to [1, gk] — one definition shared by
    the executing wrappers and the grid-step accounting."""
    if max_active_k is None:
        return gk
    return max(1, min(int(max_active_k), gk))


def ragged_dma_tiles(counts: torch.Tensor, *, gn: int) -> torch.Tensor:
    """Weight-tile loads of the ragged walk: per (m, n) panel the row's count
    active blocks; a fully skipped row still holds one resident tile."""
    return (torch.clamp(counts, min=1).sum() * gn).to(torch.int32)


def _budget_scalar(max_active_k: int | torch.Tensor | None, gk: int,
                   device: torch.device) -> torch.Tensor:
    """The budget as the accounting reads it: an int32 device scalar clamped
    to [1, gk]. A tensor (the engine's budget lane) is clamped when written
    and passes through."""
    if isinstance(max_active_k, torch.Tensor):
        return max_active_k
    return torch.full((), clamp_budget(max_active_k, gk), dtype=torch.int32,
                      device=device)


def ragged_grid_steps(
    counts: torch.Tensor, *, gm: int, gn: int, gk: int,
    max_active_k: int | torch.Tensor | None,
) -> torch.Tensor:
    """Grid steps the reference's ragged path executes (fallback-aware), f32:
    gm·gn·kb, or the full gm·gn·gk when any row overflows the budget."""
    kb = _budget_scalar(max_active_k, gk, counts.device)
    full = torch.full((), float(gm * gn * gk), dtype=torch.float32,
                      device=counts.device)
    return torch.where((counts > kb).any(), full,
                       (kb * (gm * gn)).to(torch.float32))


def budget_overflow(
    counts: torch.Tensor, *, gk: int, max_active_k: int | torch.Tensor | None
) -> torch.Tensor:
    """int32 1 when an evaluation's live counts overflow the budget (the
    reference took its full-extent fallback), else 0."""
    kb = _budget_scalar(max_active_k, gk, counts.device)
    return (counts > kb).any().to(torch.int32)


def _path_accounting(mask, *, path, dataflow, gn, budget, shard):
    """(dma_issued, grid_steps, overflow) of one reuse evaluation on `path`,
    as `core.reuse_linear` computed them beside its GEMM: None where
    `update_on_reuse` takes its own default."""
    gm, gk = mask.shape
    panels = None if shard is None else owned_panel_count(shard)
    grid_steps = overflow = None
    if path == "ragged":
        counts = (mask != 0).sum(dim=1, dtype=torch.int32)  # compact_rows'
        if shard is None:
            dma_issued = ragged_dma_tiles(counts, gn=gn)
            grid_steps = ragged_grid_steps(
                counts, gm=gm, gn=gn, gk=gk, max_active_k=budget)
        else:
            dma_issued = ragged_dma_tiles(counts, gn=1) * panels
            grid_steps = ragged_grid_steps(
                counts, gm=gm, gn=1, gk=gk, max_active_k=budget) * float(panels)
        overflow = budget_overflow(counts, gk=gk, max_active_k=budget)
    elif path == "compact":
        # the reference's gather streams each live K-block's weight panel
        # once, shared by all rows
        live = mask.amax(dim=0).sum(dtype=torch.int32)
        if shard is None:
            dma_issued = live * gn
            grid_steps = ragged_grid_steps(
                live.expand(gm), gm=gm, gn=gn, gk=gk, max_active_k=budget)
        else:
            dma_issued = live * panels
            grid_steps = ragged_grid_steps(
                live.expand(gm), gm=gm, gn=1, gk=gk,
                max_active_k=budget) * float(panels)
        overflow = budget_overflow(live, gk=gk, max_active_k=budget)
    elif path in ("kernel", "dense"):
        # the masked full-grid semantics
        dma_issued = weight_dma_tiles(mask, gn=gn if shard is None else 1,
                                      dataflow=dataflow)
        if shard is not None:
            dma_issued = dma_issued * panels
            # the masked full-grid walk over the shard's owned global panels
            grid_steps = torch.full((), float(gm * gk * panels),
                                    dtype=torch.float32, device=mask.device)
    else:
        raise ValueError(f"unknown exec_path {path!r}")
    return dma_issued, grid_steps, overflow


def site_account_torch(
    cur_q: torch.Tensor,             # [M, K] int8, this call's codes
    block_mask: torch.Tensor | None,  # [gm, gk] int32; None: basic mode
    cache: dict,
    *,
    path: str,
    dataflow: str,
    block_m: int,
    block_k: int,
    n: int,
    gn: int,
    w_itemsize: int,
    ema_decay: float,
    budget: int | torch.Tensor | None,
    shard: ShardCtx | None = None,
) -> torch.Tensor:
    """Plain version: the bookkeeping of one site call on `cache` (in
    place), as `core.reuse_linear` ran it eagerly. Returns the per-row match
    counts, [M] f32."""
    m, k = cur_q.shape
    matches = row_code_matches(cur_q, cache["prev_q"])
    cache["prev_q"].copy_(cur_q)
    cache["sim_ema"].copy_(
        ema_update_mean(cache["sim_ema"], matches, k, ema_decay))
    cache["steps"].add_(1)
    if block_mask is None:
        if "sensor" in cache:
            update_on_basic(
                cache["sensor"], row_matches=matches, m=m, k=k, n=n, gn=gn,
                block_m=block_m, block_k=block_k, w_itemsize=w_itemsize,
                shard=shard)
        return matches
    gm, gk = block_mask.shape
    if "ctrl" in cache:
        occ = cache["ctrl"]["occupancy"]
        occ.copy_(ema_update_mean(occ, block_mask.sum(dtype=torch.float32),
                                  gm * gk, ema_decay))
    if "sensor" in cache:
        dma_issued, grid_steps, overflow = _path_accounting(
            block_mask, path=path, dataflow=dataflow, gn=gn, budget=budget,
            shard=shard)
        update_on_reuse(
            cache["sensor"], block_mask=block_mask, row_matches=matches, k=k,
            block_m=block_m, block_k=block_k, n=n, gn=gn,
            w_itemsize=w_itemsize, dma_issued=dma_issued,
            grid_steps=grid_steps, overflow=overflow, shard=shard)
    return matches


def _f32(x: float) -> float:
    """x rounded to f32, as a Python float."""
    return float(np.float32(x))


def plan(
    *, m: int, k: int, gm: int, gk: int, basic: bool, path: str,
    dataflow: str, block_m: int, block_k: int, n: int, gn: int,
    w_itemsize: int, ema_decay: float, budget: int | None,
    shard: ShardCtx | None,
) -> tuple[dict[str, int], dict[str, float]]:
    """The kernel's by-value arguments besides its pointers: the geometry as
    ints and every constant the twin rounds to f32 before it meets a lane
    (a Python float times an f32 tensor is an f32 product). `budget` is the
    clamped Python budget, read where the call has no budget lane."""
    if shard is None:
        total, n_acct, g = gm * gk, n, gn
    else:
        total = gm * owned_k_count(gk, shard)
        n_acct, g = shard.n_total, owned_panel_count(shard)
    gn_grid = gn if shard is None else 1  # the ragged formula's panels
    macs = float(block_m * block_k * n_acct)
    tile_w = float(block_k * n_acct * w_itemsize)
    ints = {
        "gm": gm, "gk": gk, "basic": int(basic),
        "path": PATHS.index(path) if not basic else 0,
        "output": int(dataflow == "output"),
        "shard_count": 0 if shard is None else shard.count,
        "shard_index": 0 if shard is None else shard.index,
        "g": g, "total": total, "grid_rate": gm * gn_grid,
        "budget": clamp_budget(budget, gk),
    }
    floats = {
        "decay": _f32(ema_decay),
        "c_sim": _f32(np.float32(1.0 - ema_decay) * np.float32(1.0 / k)),
        "c_occ": _f32(np.float32(1.0 - ema_decay) * np.float32(1.0 / (gm * gk))),
        "inv_k": _f32(1.0 / k),
        "macs": _f32(macs),
        "tile_w": _f32(tile_w),
        "row_elems": _f32(float(block_m * n)),
        "total_macs": _f32(float(total) * macs),
        "total_w": _f32(float(total) * tile_w),
        "grid_full": _f32(float(gm * gk * g)),
        "grid_over": _f32(float(gm * gn_grid * gk)),
        "panels": _f32(float(g)),
    }
    return ints, floats


INTS = ("m", "k", "ldq", "chunks", "vec", "gm", "gk", "basic", "path",
        "output", "shard_count", "shard_index", "g", "total", "grid_rate",
        "budget", "has_ctrl", "has_sensor")
FLOATS = ("decay", "c_sim", "c_occ", "inv_k", "macs", "tile_w", "row_elems",
          "total_macs", "total_w", "grid_full", "grid_over", "panels")


def _lane_specs(m: int, k: int) -> dict[str, tuple[torch.dtype, tuple]]:
    """(dtype, shape) of each lane the kernel writes, as `core.reuse_cache.
    init_site_cache` and `sensor.counters.init_site_counters` make them."""
    f32, i32 = torch.float32, torch.int32
    specs = {"prev_q": (torch.int8, (m, k)), "sim_ema": (f32, (m,)),
             "steps": (i32, ()), "ctrl.occupancy": (f32, ())}
    for name in SENSOR_LANES:
        dtype = i32 if name.endswith(("tiles", "fallbacks", "flag",
                                      "transitions", "slot_steps")) else f32
        specs[f"sensor.{name}"] = (dtype, (m,) if name.startswith("slot")
                                   else ())
    return specs


def written_lanes(cache: dict) -> dict[str, torch.Tensor]:
    """The lanes a site call's bookkeeping writes, by name ("sensor.x",
    "ctrl.occupancy"): the cache entry's own tensors."""
    lanes = {name: cache[name] for name in ("prev_q", "sim_ema", "steps")}
    if "ctrl" in cache:
        lanes["ctrl.occupancy"] = cache["ctrl"]["occupancy"]
    for name in SENSOR_LANES if "sensor" in cache else ():
        lanes[f"sensor.{name}"] = cache["sensor"][name]
    return lanes


def copy_lanes(cache: dict) -> dict:
    """A cache entry holding copies of the lanes the bookkeeping reads and
    writes (and the scale the fused pass reads), for running the plain
    version beside the kernel."""
    out = {name: cache[name].clone() for name in ("prev_q", "sim_ema",
                                                  "steps", "scale")}
    if "ctrl" in cache:
        out["ctrl"] = {"occupancy": cache["ctrl"]["occupancy"].clone()}
    if "sensor" in cache:
        out["sensor"] = {k: v.clone() for k, v in cache["sensor"].items()}
    return out


def differing_lanes(got: dict, want: dict) -> list[str]:
    """Names of the lanes of `got` that differ from `want`'s (two
    `written_lanes`): bitwise, NaN positions included, NaN payloads not
    compared (the card's FMA returns the canonical NaN). The comparisons
    stay on the device and come back in one transfer."""
    bad = [name for name, b in want.items()
           if got[name].dtype != b.dtype or got[name].shape != b.shape]
    same = {}
    for name, b in want.items():
        if name in bad:
            continue
        a = got[name]
        if a.is_floating_point():
            nan = torch.isnan(b)
            bits = a.view(torch.int32) == b.view(torch.int32)
            same[name] = (torch.isnan(a) == nan).all() & (bits | nan).all()
        else:
            same[name] = (a == b).all()
    if same:
        flags = torch.stack(list(same.values())).tolist()
        bad += [name for name, ok in zip(same, flags) if not ok]
    return bad


def _check_lanes(m, k, device, block_mask, cache, budget, what) -> None:
    """The kernels' contract on the cache entry: its lanes contiguous, of
    the reference's dtypes and shapes, on `device`."""
    specs = _lane_specs(m, k)
    lanes = dict(written_lanes(cache))
    if block_mask is not None:
        specs["mask"] = (torch.int32, tuple(block_mask.shape))
        lanes["mask"] = block_mask
    if isinstance(budget, torch.Tensor):
        specs["budget"] = (torch.int32, ())
        lanes["budget"] = budget
    for name, t in lanes.items():
        dtype, shape = specs[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {t.dtype} "
                             f"{tuple(t.shape)} != {dtype} {shape}")
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch_args(cache, *, cur_q, partial, matches, block_mask, budget,
                 ints, floats):
    """The C entries' lane pointers and by-value arrays (ctypes), in the
    order of `csrc/site_account.cuh`'s Lanes, Ints and Floats."""
    sensor = cache.get("sensor", {})
    ptrs = [cur_q, cache["prev_q"], partial, matches, block_mask,
            budget if isinstance(budget, torch.Tensor) else None,
            cache["sim_ema"], cache["steps"],
            cache["ctrl"]["occupancy"] if "ctrl" in cache else None,
            *(sensor.get(name) for name in SENSOR_LANES)]
    ptrs = [0 if t is None else t.data_ptr() for t in ptrs]
    ints.update(has_ctrl=int("ctrl" in cache),
                has_sensor=int("sensor" in cache))
    return ((ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
            (ctypes.c_int * len(INTS))(*(ints[n] for n in INTS)), len(INTS),
            (ctypes.c_float * len(FLOATS))(*(floats[n] for n in FLOATS)),
            len(FLOATS))


def _plan_for(m, k, gm, gk, basic, kw):
    return plan(m=m, k=k, gm=gm, gk=gk, basic=basic, path=kw["path"],
                dataflow=kw["dataflow"], block_m=kw["block_m"],
                block_k=kw["block_k"], n=kw["n"], gn=kw["gn"],
                w_itemsize=kw["w_itemsize"], ema_decay=kw["ema_decay"],
                budget=(None if isinstance(kw["budget"], torch.Tensor)
                        else kw["budget"]),
                shard=kw["shard"])


def site_account(
    cur_q: torch.Tensor,
    block_mask: torch.Tensor | None,
    cache: dict,
    *,
    path: str,
    dataflow: str,
    block_m: int,
    block_k: int,
    n: int,
    gn: int,
    w_itemsize: int,
    ema_decay: float,
    budget: int | torch.Tensor | None,
    shard: ShardCtx | None = None,
) -> torch.Tensor:
    """One site call's bookkeeping, in place on `cache`. Returns the match
    counts [M] f32 (on the card, the wrapper's scratch, which the kernel
    writes). CPU tensors take `site_account_torch`."""
    kw = dict(path=path, dataflow=dataflow, block_m=block_m, block_k=block_k,
              n=n, gn=gn, w_itemsize=w_itemsize, ema_decay=ema_decay,
              budget=budget, shard=shard)
    if cur_q.device.type == "cpu":
        return site_account_torch(cur_q, block_mask, cache, **kw)
    if cur_q.device.type != "cuda":
        raise ValueError(f"site_account: unsupported device {cur_q.device}")
    m, k = cur_q.shape
    if cur_q.dtype != torch.int8 or cur_q.stride(1) != 1:
        raise ValueError("site_account: cur_q must be int8 with unit column "
                         f"stride, got {cur_q.dtype} strides {cur_q.stride()}")
    _check_lanes(m, k, cur_q.device, block_mask, cache, budget,
                 "site_account")
    if block_mask is None:
        gm, gk = -(-m // block_m), -(-k // block_k)
    else:
        gm, gk = block_mask.shape
    ints, floats = _plan_for(m, k, gm, gk, block_mask is None, kw)
    chunks = -(-k // CHUNK)
    partial = torch.empty(m * chunks, dtype=torch.int32, device=cur_q.device)
    matches = torch.empty(m, dtype=torch.float32, device=cur_q.device)
    ints.update(
        m=m, k=k, ldq=cur_q.stride(0), chunks=chunks,
        vec=int(k % 16 == 0 and cur_q.stride(0) % 16 == 0
                and cur_q.data_ptr() % 16 == 0
                and cache["prev_q"].data_ptr() % 16 == 0))
    rc = backend.library("site_account").rt_site_account(
        *_launch_args(cache, cur_q=cur_q, partial=partial, matches=matches,
                      block_mask=block_mask, budget=budget, ints=ints,
                      floats=floats),
        backend.stream_ptr(cur_q.device))
    backend.check(rc, "site_account")
    backend.count_launch("site_account")
    return matches


def delta_quant_account_torch(
    x: torch.Tensor,
    cache: dict,
    *,
    block_m: int,
    block_k: int,
    delta_dtype: torch.dtype,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused pass: `delta_quant_torch` on x and
    prev_q padded with zeros to whole tiles (as `ops.delta_quant_fused`
    pads them), then `site_account_torch` on the codes. Returns (delta
    [M, K], mask [gm, gk], matches [M])."""
    m, k = x.shape
    pad = (0, -k % block_k, 0, -m % block_m)
    q, delta, mask = delta_quant_torch(
        F.pad(x, pad), F.pad(cache["prev_q"], pad), cache["scale"],
        block_m=block_m, block_k=block_k, delta_dtype=delta_dtype)
    matches = site_account_torch(q[:m, :k], mask, cache, block_m=block_m,
                                 block_k=block_k, **kw)
    return delta[:m, :k], mask, matches


def delta_quant_account(
    x: torch.Tensor,          # [M, K] f32 / bf16, this call's activations
    cache: dict,              # the site's entry (or shard lane)
    *,
    block_m: int,
    block_k: int,
    delta_dtype: torch.dtype,
    path: str,
    dataflow: str,
    n: int,
    gn: int,
    w_itemsize: int,
    ema_decay: float,
    budget: int | torch.Tensor | None,
    shard: ShardCtx | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A reuse-mode site call's pass before its ΔW GEMM, in place on
    `cache`: the codes into prev_q and every bookkeeping lane. Returns
    (delta [M, K] (a view of whole tiles), mask int32 [gm, gk], matches [M]
    f32). One launch of `csrc/delta_quant.cu`'s fused instance on CUDA
    tensors; CPU tensors take `delta_quant_account_torch`."""
    kw = dict(path=path, dataflow=dataflow, n=n, gn=gn,
              w_itemsize=w_itemsize, ema_decay=ema_decay, budget=budget,
              shard=shard)
    if x.device.type == "cpu":
        return delta_quant_account_torch(x, cache, block_m=block_m,
                                         block_k=block_k,
                                         delta_dtype=delta_dtype, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"delta_quant_account: unsupported device {x.device}")
    m, k = x.shape
    scale = cache["scale"]
    if x.dtype not in backend.DTYPE_CODE or delta_dtype not in backend.DTYPE_CODE:
        raise TypeError(f"delta_quant_account: x {x.dtype} / delta "
                        f"{delta_dtype} must be float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("delta_quant_account: x must be contiguous")
    if scale.dtype != torch.float32 or scale.numel() != 1 or \
            scale.device != x.device:
        raise TypeError("delta_quant_account: scale must be one float32 on "
                        f"{x.device}")
    _check_lanes(m, k, x.device, None, cache, budget, "delta_quant_account")
    gm, gk = -(-m // block_m), -(-k // block_k)
    delta = torch.empty((gm * block_m, gk * block_k), dtype=delta_dtype,
                        device=x.device)
    mask = torch.empty((gm, gk), dtype=torch.int32, device=x.device)
    partial = torch.empty(m * gk, dtype=torch.int32, device=x.device)
    matches = torch.empty(m, dtype=torch.float32, device=x.device)
    ints, floats = _plan_for(m, k, gm, gk, False,
                             dict(kw, block_m=block_m, block_k=block_k))
    vec = int(block_k % 8 == 0 and k % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, cache["prev_q"], delta)))
    ints.update(m=m, k=k, ldq=k, chunks=gk, vec=vec)
    rc = backend.library("delta_quant").rt_delta_quant_account(
        x.data_ptr(), backend.DTYPE_CODE[x.dtype], scale.data_ptr(),
        delta.data_ptr(), backend.DTYPE_CODE[delta_dtype], m, k, block_m,
        block_k, vec,
        *_launch_args(cache, cur_q=None, partial=partial, matches=matches,
                      block_mask=mask, budget=budget, ints=ints,
                      floats=floats),
        backend.stream_ptr(x.device))
    backend.check(rc, "delta_quant_account")
    backend.count_launch("delta_quant_account")
    return delta[:m, :k], mask, matches
