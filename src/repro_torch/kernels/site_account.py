"""A reuse site call's cache bookkeeping after its ΔW GEMM, as one kernel.

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
kernels a site call. `site_account` launches `csrc/site_account.cu` on CUDA
tensors: a row pass (the match counts and the `prev_q` write) and a one-CTA
epilogue (every other lane). It takes `site_account_torch`, today's code
gathered into one function, on CPU tensors. Every lane is updated in place,
in the cache entry's own tensors (a CUDA graph reads them), and is bitwise
the twin's: the kernel rounds once where the twin's `fma_f32` does and twice
where the twin multiplies and then adds. NaN lanes stay NaN in the same
positions; their payloads may differ (the card's FMA returns the canonical
NaN).

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

from repro_torch.core.similarity import ema_update_mean, row_code_matches
from repro_torch.kernels import backend
from repro_torch.kernels.reuse_matmul import weight_dma_tiles
from repro_torch.sensor.counters import (
    ShardCtx,
    owned_k_count,
    owned_panel_count,
    update_on_basic,
    update_on_reuse,
)

# csrc/site_account.cu kChunk: the bytes of a row that one CTA of the row
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
    writes, for running the plain version beside the kernel."""
    out = {name: cache[name].clone() for name in ("prev_q", "sim_ema",
                                                  "steps")}
    if "ctrl" in cache:
        out["ctrl"] = {"occupancy": cache["ctrl"]["occupancy"].clone()}
    if "sensor" in cache:
        out["sensor"] = {k: v.clone() for k, v in cache["sensor"].items()}
    return out


def differing_lanes(got: dict, want: dict) -> list[str]:
    """Names of the lanes of `got` that differ from `want`'s (two
    `written_lanes`): bitwise, NaN positions included, NaN payloads not
    compared (the card's FMA returns the canonical NaN)."""
    bad = []
    for name, b in want.items():
        a = got[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(name)
        elif a.is_floating_point():
            nan = torch.isnan(b)
            if not (torch.equal(torch.isnan(a), nan) and torch.equal(
                    a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])):
                bad.append(name)
        elif not torch.equal(a, b):
            bad.append(name)
    return bad


def _check(cur_q, block_mask, cache, budget) -> None:
    """The kernel's contract: int8 codes with unit column stride, the cache's
    lanes contiguous, of the reference's dtypes and shapes, on one device."""
    m, k = cur_q.shape
    if cur_q.dtype != torch.int8 or cur_q.stride(1) != 1:
        raise ValueError("site_account: cur_q must be int8 with unit column "
                         f"stride, got {cur_q.dtype} strides {cur_q.stride()}")
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
            raise ValueError(f"site_account: {name} {t.dtype} "
                             f"{tuple(t.shape)} != {dtype} {shape}")
        if t.device != cur_q.device:
            raise ValueError(f"site_account: {name} on {t.device}, cur_q on "
                             f"{cur_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"site_account: {name} must be contiguous")


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
    _check(cur_q, block_mask, cache, budget)
    m, k = cur_q.shape
    if block_mask is None:
        gm, gk = -(-m // block_m), -(-k // block_k)
    else:
        gm, gk = block_mask.shape
    ints, floats = plan(
        m=m, k=k, gm=gm, gk=gk, basic=block_mask is None, path=path,
        dataflow=dataflow, block_m=block_m, block_k=block_k, n=n, gn=gn,
        w_itemsize=w_itemsize, ema_decay=ema_decay,
        budget=None if isinstance(budget, torch.Tensor) else budget,
        shard=shard)
    chunks = -(-k // CHUNK)
    partial = torch.empty(m * chunks, dtype=torch.int32, device=cur_q.device)
    matches = torch.empty(m, dtype=torch.float32, device=cur_q.device)
    prev_q = cache["prev_q"]
    sensor = cache.get("sensor", {})
    ptrs = [cur_q, prev_q, partial, matches, block_mask,
            budget if isinstance(budget, torch.Tensor) else None,
            cache["sim_ema"], cache["steps"],
            cache["ctrl"]["occupancy"] if "ctrl" in cache else None,
            *(sensor.get(name) for name in SENSOR_LANES)]
    ptrs = [0 if t is None else t.data_ptr() for t in ptrs]
    ints.update(
        m=m, k=k, ldq=cur_q.stride(0), chunks=chunks,
        vec=int(k % 16 == 0 and cur_q.stride(0) % 16 == 0
                and ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0),
        has_ctrl=int("ctrl" in cache), has_sensor=int("sensor" in cache))
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(INTS))(*(ints[n] for n in INTS))
    c_floats = (ctypes.c_float * len(FLOATS))(*(floats[n] for n in FLOATS))
    rc = backend.library("site_account").rt_site_account(
        c_ptrs, len(ptrs), c_ints, len(INTS), c_floats, len(FLOATS),
        backend.stream_ptr(cur_q.device))
    backend.check(rc, "site_account")
    backend.count_launch("site_account")
    return matches
