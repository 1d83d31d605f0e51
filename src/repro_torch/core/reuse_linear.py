"""reuse_linear — one reuse site: O_c = O_p + Δ·W (paper Eqns. 2-4).

Caches start at prev_q = 0, prev_out = 0, so the first evaluation is the
ordinary quantized GEMM and every later one telescopes:
O_t = Σ_{i<=t} Δ_i · W = dequant(q_t) · W (to f32 rounding).

The cache entry is updated IN PLACE, so the stacked per-layer cache needs no
copy back; the function returns the same entry for symmetry with the
reference. prev_out takes the GEMM's output by a copy; every other lane
(prev_q, sim_ema, steps, the ctrl occupancy and the sensor counters) is the
call's bookkeeping, bitwise the reference's compiled step: in reuse mode
fused into the delta/quant/mask pass before the GEMM
(`ops.delta_quant_account`, one kernel on the card: the GEMM reads none of
those lanes), in basic mode `ops.site_account` after the product (one
kernel). `ReuseStats` is computed only when read.

Timing marks (`obs.trace.mark`, events only inside a marked decode
graph's capture): `ReuseEngine.apply` marks the call's entry and the end
of its `epilogue`, this module the ends of its `quant` (the delta/quant
pass, or basic mode's quantize) and `product` (the ΔW GEMM, or basic
mode's product) phases; the epilogue is the prev_out copy, basic mode's
bookkeeping, the bias add and the cast.

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

import torch

from repro_torch.core.reuse_cache import (
    ReuseSiteSpec,
    kernel_impl,
    resolve_exec_path,
)
from repro_torch.core.similarity import fma_f32
from repro_torch.kernels import ops
from repro_torch.obs import trace
from repro_torch.quant import dequantize_int8, quantize_int8
from repro_torch.sensor.counters import ShardCtx


class ReuseStats:
    """A call's code-level similarity and the fraction of its weight tiles
    skipped, the reference's `ReuseStats` fields, computed when read from
    the call's match counts and tile mask: the serve discards them, so they
    launch nothing unless read. On the card the match counts are the
    bookkeeping kernel's scratch; a call captured in a CUDA graph holds the
    counts of its graph's latest replay."""

    __slots__ = ("_matches", "_mask", "_k")

    def __init__(self, matches: torch.Tensor, mask: torch.Tensor | None,
                 k: int):
        self._matches, self._mask, self._k = matches, mask, k

    @property
    def similarity(self) -> torch.Tensor:
        """Code-level similarity this call (f32 scalar): the mean of the
        rows' similarities as the reference's compiled step computes it, one
        FMA of each row's match count and f32(1/K) into a running sum, row
        by row, times the f32 reciprocal of the row count. XLA's CPU backend
        keeps that row order up to 16 rows; past that it vectorizes the sum
        in an order not reproduced here (the value then differs in the last
        bits)."""
        acc = torch.zeros((), dtype=torch.float32,
                          device=self._matches.device)
        for row in self._matches:
            acc = fma_f32(row, 1.0 / self._k, acc)
        return acc * (1.0 / self._matches.numel())

    @property
    def skip_fraction(self) -> torch.Tensor:
        """Fraction of weight tiles skipped this call (f32 scalar; 0 in
        basic mode): 1 − mean(mask) as the compiled step contracts it,
        fma(−Σ mask, f32(1/n), 1)."""
        if self._mask is None:
            return torch.zeros((), device=self._matches.device)
        one = torch.ones((), dtype=torch.float32, device=self._mask.device)
        return fma_f32(-self._mask.sum(dtype=torch.float32),
                       1.0 / self._mask.numel(), one)


def _basic_eval(xm, w, cache, spec: ReuseSiteSpec, impl: str,
                ema_decay: float, shard: ShardCtx | None = None):
    """ReuseOFF: the plain quantized GEMM, with the cache refreshed (the
    bookkeeping after the product, `ops.site_account`)."""
    cur_q = quantize_int8(xm, cache["scale"])
    xq = dequantize_int8(cur_q, cache["scale"], dtype=xm.dtype)
    trace.mark(spec.name, "quant")
    out = ops.f32_product(xq, w)  # the basic-mode product
    trace.mark(spec.name, "product")
    cache["prev_out"].copy_(out)
    n = w.shape[-1]
    matches = ops.site_account(
        cur_q, None, cache, path="kernel", dataflow=spec.dataflow,
        block_m=spec.block_m, block_k=spec.block_k, n=n,
        gn=-(-n // spec.block_n), w_itemsize=w.element_size(),
        ema_decay=ema_decay, budget=spec.max_active_k, shard=shard,
        impl=kernel_impl(impl))
    return out, ReuseStats(matches, None, xm.shape[1])


def _reuse_eval(xm, w, cache, spec: ReuseSiteSpec, impl: str,
                ema_decay: float, budget: torch.Tensor | None,
                shard: ShardCtx | None = None):
    """ReuseON: delta-encode against the previous evaluation, with the
    call's bookkeeping in the same pass, then run the ΔW GEMM on the spec's
    execution path."""
    n_total = None if shard is None else shard.n_total
    sub = kernel_impl(impl)
    path = resolve_exec_path(spec, impl)
    n = w.shape[-1]
    delta, mask, matches = ops.delta_quant_account(
        xm, cache, block_m=spec.block_m, block_k=spec.block_k,
        delta_dtype=w.dtype, path=path, dataflow=spec.dataflow, n=n,
        gn=-(-n // spec.block_n), w_itemsize=w.element_size(),
        ema_decay=ema_decay,
        budget=spec.max_active_k if budget is None else budget, shard=shard,
        impl=sub)
    trace.mark(spec.name, "quant")
    if path == "dense":
        out = ops.reuse_matmul_ref(delta, w, cache["prev_out"], mask,
                                   spec.block_m, spec.block_k)
    elif path == "ragged":
        out = ops.reuse_matmul_ragged(
            delta, w, cache["prev_out"], mask,
            block_m=spec.block_m, block_n=spec.block_n, block_k=spec.block_k,
            impl=sub, compacted=ops.compact_rows(mask), n_total=n_total,
        )
    elif path == "compact":
        out = ops.reuse_matmul_compact(delta, w, cache["prev_out"],
                                       mask.amax(dim=0), block_k=spec.block_k)
    elif path == "kernel":
        out = ops.reuse_matmul(
            delta, w, cache["prev_out"], mask,
            block_m=spec.block_m, block_n=spec.block_n, block_k=spec.block_k,
            dataflow=spec.dataflow, impl=sub, n_total=n_total,
        )
    else:
        raise ValueError(f"unknown exec_path {path!r} of site {spec.name!r}")
    trace.mark(spec.name, "product")
    cache["prev_out"].copy_(out)
    return out, ReuseStats(matches, mask, xm.shape[1])


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
        out, stats = _basic_eval(xm, w, cache, spec, impl, ema_decay, shard)
    elif mode == "reuse":
        out, stats = _reuse_eval(xm, w, cache, spec, impl, ema_decay, budget,
                                 shard)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if b is not None:
        out = out + b.to(out.dtype)
    return out.to(x.dtype).reshape(*lead, n), cache, stats
