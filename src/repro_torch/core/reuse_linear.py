"""reuse_linear — one reuse site: O_c = O_p + Δ·W (paper Eqns. 2-4).

Caches start at prev_q = 0, prev_out = 0, so the first evaluation is the
ordinary quantized GEMM and every later one telescopes:
O_t = Σ_{i<=t} Δ_i · W = dequant(q_t) · W (to f32 rounding).

The cache entry is updated IN PLACE (prev_q, prev_out, sim_ema, steps, the
ctrl occupancy and the sensor counters), so the stacked per-layer cache needs
no copy back; the function returns the same entry for symmetry with the
reference.

kernelMode: `mode=None` reads the layer's lane of the host mirror
(`cache["mode_host"]`, kept equal to `ctrl["mode_id"]` by the engine's host
passes) instead of branching on the device lane, which would cost one
device→host sync per site per layer. A string mode pins the branch.

`impl`: "cuda" — the Hopper kernels (their plain twins for CPU tensors);
"torch" — the plain versions on any device (the reference's XLA-tier twin);
"jnp" — the reference's serve tier: the kernels as "cuda" (`kernel_impl`),
but an "auto" site runs "dense" and the policy promotes to "compact". On all
three, quantize → delta → tile-mask is one fused pass. "kernel" runs the
masked block-skip kernel, "ragged" the compacted walk, "compact" the
reference's gather GEMM over the k-blocks any row changed (here the plain
product, with the reference's accounting), and "dense" (also the guard's
shadow oracle) the reference's masked product `ops.reuse_matmul_ref`; the
last two are torch ops, as the reference's are jnp outside any kernel.

`budget`: the ragged and compact accounting's k-extent budget as a device
scalar (the engine's budget lane, written in place by budget moves, so a
captured graph reads the live value); None reads the spec's
`max_active_k`.

`shard` (a `ShardCtx`): one model-axis shard's evaluation. `w` is then the
shard's column panel of the site's weight (a view, read in place) and the
cache entry the shard's lane; the product is the unsharded one on fewer
columns, with the k split of the global N (`n_total`), and only the
accounting changes: the ownership partition of `sensor.counters` (dma and
grid steps at gn = 1 times the shard's owned global n-panels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.reuse_cache import (
    ReuseSiteSpec,
    kernel_impl,
    resolve_exec_path,
)
from repro_torch.core.similarity import ema_update_mean, row_code_matches
from repro_torch.kernels import ops
from repro_torch.quant import dequantize_int8, quantize_int8
from repro_torch.sensor.counters import (
    ShardCtx,
    owned_panel_count,
    update_on_basic,
    update_on_reuse,
)


class ReuseStats(NamedTuple):
    similarity: torch.Tensor     # code-level similarity this call
    skip_fraction: torch.Tensor  # fraction of weight tiles skipped this call


def _basic_eval(xm, w, cache, spec: ReuseSiteSpec, ema_decay: float,
                shard: ShardCtx | None = None):
    """ReuseOFF: the plain quantized GEMM, with the cache refreshed."""
    m, k = xm.shape
    n = w.shape[-1]
    cur_q = quantize_int8(xm, cache["scale"])
    xq = dequantize_int8(cur_q, cache["scale"], dtype=xm.dtype)
    out = ops.f32_product(xq, w)  # the basic-mode product
    matches = row_code_matches(cur_q, cache["prev_q"])
    cache["prev_q"].copy_(cur_q)
    cache["prev_out"].copy_(out)
    cache["sim_ema"].copy_(
        ema_update_mean(cache["sim_ema"], matches, k, ema_decay))
    cache["steps"].add_(1)
    if "sensor" in cache:
        update_on_basic(
            cache["sensor"], row_matches=matches, m=m, k=k, n=n,
            gn=-(-n // spec.block_n), block_m=spec.block_m,
            block_k=spec.block_k, w_itemsize=w.element_size(), shard=shard,
        )
    stats = ReuseStats(similarity=(matches * (1.0 / k)).mean(),
                       skip_fraction=torch.zeros((), device=xm.device))
    return out, stats


def _reuse_eval(xm, w, cache, spec: ReuseSiteSpec, impl: str,
                ema_decay: float, budget: torch.Tensor | None,
                shard: ShardCtx | None = None):
    """ReuseON: delta-encode against the previous evaluation and run the ΔW
    GEMM on the spec's execution path."""
    n = w.shape[-1]
    # a shard's dma and grid steps: the per-panel formula at gn = 1 times
    # the global n-panels it owns
    panels = None if shard is None else owned_panel_count(shard)
    n_total = None if shard is None else shard.n_total
    sub = kernel_impl(impl)
    cur_q, delta, mask = ops.delta_quant_fused(
        xm, cache["prev_q"], cache["scale"],
        block_m=spec.block_m, block_k=spec.block_k, delta_dtype=w.dtype,
        impl=sub,
    )
    path = resolve_exec_path(spec, impl)
    gm, gk = mask.shape
    gn = -(-n // spec.block_n)
    sel = dma_issued = grid_steps = overflow = None
    kb = spec.max_active_k if budget is None else budget
    if path == "dense":
        out = ops.reuse_matmul_ref(delta, w, cache["prev_out"], mask,
                                   spec.block_m, spec.block_k)
    elif path == "ragged":
        idx, counts = ops.compact_rows(mask)
        out = ops.reuse_matmul_ragged(
            delta, w, cache["prev_out"], mask,
            block_m=spec.block_m, block_n=spec.block_n, block_k=spec.block_k,
            impl=sub, compacted=(idx, counts), n_total=n_total,
        )
        if shard is None:
            dma_issued = ops.ragged_dma_tiles(counts, gn=gn)
            grid_steps = ops.ragged_grid_steps(
                counts, gm=gm, gn=gn, gk=gk, max_active_k=kb)
        else:
            dma_issued = ops.ragged_dma_tiles(counts, gn=1) * panels
            grid_steps = ops.ragged_grid_steps(
                counts, gm=gm, gn=1, gk=gk, max_active_k=kb) * float(panels)
        overflow = ops.budget_overflow(counts, gk=gk, max_active_k=kb)
    elif path == "compact":
        k_mask = mask.amax(dim=0)
        out = ops.reuse_matmul_compact(delta, w, cache["prev_out"], k_mask,
                                       block_k=spec.block_k)
        # the reference's gather streams each live K-block's weight panel
        # once, shared by all rows
        live = k_mask.sum(dtype=torch.int32)
        if shard is None:
            dma_issued = live * gn
            grid_steps = ops.ragged_grid_steps(
                live.expand(gm), gm=gm, gn=gn, gk=gk, max_active_k=kb)
        else:
            dma_issued = live * panels
            grid_steps = ops.ragged_grid_steps(
                live.expand(gm), gm=gm, gn=1, gk=gk,
                max_active_k=kb) * float(panels)
        overflow = ops.budget_overflow(live, gk=gk, max_active_k=kb)
    elif path == "kernel":
        sel = ops.skip_sel(mask)
        out = ops.reuse_matmul(
            delta, w, cache["prev_out"], mask,
            block_m=spec.block_m, block_n=spec.block_n, block_k=spec.block_k,
            dataflow=spec.dataflow, impl=sub, n_total=n_total,
        )
    else:
        raise ValueError(f"unknown exec_path {path!r} of site {spec.name!r}")
    k = xm.shape[1]
    matches = row_code_matches(cur_q, cache["prev_q"])
    cache["prev_q"].copy_(cur_q)
    cache["prev_out"].copy_(out)
    cache["sim_ema"].copy_(
        ema_update_mean(cache["sim_ema"], matches, k, ema_decay))
    cache["steps"].add_(1)
    if "ctrl" in cache:
        occ = cache["ctrl"]["occupancy"]
        occ.copy_(ema_update_mean(occ, mask.sum(dtype=torch.float32),
                                  gm * gk, ema_decay))
    if "sensor" in cache:
        if dma_issued is None:  # kernel/dense: masked full-grid semantics
            dma_issued = ops.weight_dma_tiles(
                mask, gn=gn if shard is None else 1, dataflow=spec.dataflow,
                sel=sel)
            if shard is not None:
                dma_issued = dma_issued * panels
        if grid_steps is None and shard is not None:
            # the masked full-grid walk over the shard's owned global panels
            grid_steps = torch.full((), float(gm * gk * panels),
                                    dtype=torch.float32, device=mask.device)
        update_on_reuse(
            cache["sensor"], block_mask=mask, row_matches=matches, k=k,
            block_m=spec.block_m, block_k=spec.block_k, n=n, gn=gn,
            w_itemsize=w.element_size(), dma_issued=dma_issued,
            grid_steps=grid_steps, overflow=overflow, shard=shard,
        )
    stats = ReuseStats(similarity=(matches * (1.0 / k)).mean(),
                       skip_fraction=1.0 - mask.float().mean())
    return out, stats


def reuse_linear(
    x: torch.Tensor,            # [..., K]
    w: torch.Tensor,            # [K, N]
    b: torch.Tensor | None,
    cache: dict,
    spec: ReuseSiteSpec,
    *,
    mode: str | None = "reuse",  # "reuse" | "basic" | None (= host mirror)
    impl: str = "cuda",
    ema_decay: float = 0.9,
    budget: torch.Tensor | None = None,
    shard: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict, ReuseStats]:
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    xm = x.reshape(-1, k).contiguous()
    m = xm.shape[0]
    if tuple(cache["prev_q"].shape) != (m, k):
        raise ValueError(f"site {spec.name!r}: prev_q "
                         f"{tuple(cache['prev_q'].shape)} != {(m, k)}")
    if mode is None:
        mode = "reuse" if int(cache["mode_host"]) > 0 else "basic"
    if mode == "basic":
        out, stats = _basic_eval(xm, w, cache, spec, ema_decay, shard)
    elif mode == "reuse":
        out, stats = _reuse_eval(xm, w, cache, spec, impl, ema_decay, budget,
                                 shard)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if b is not None:
        out = out + b.to(out.dtype)
    return out.to(x.dtype).reshape(*lead, n), cache, stats
