"""Public kernel API: padding, dispatch, and the sensor's accounting functions.

Execution paths of the reuse-mode ΔW GEMM (`ReuseSiteSpec.exec_path`):
  "kernel" — block-skip GEMM on the full tile grid (`reuse_matmul`).
  "ragged" — compacted walk over each row's active k-blocks
             (`reuse_matmul_ragged`).
  "compact" — the reference's gather GEMM over the k-blocks any row
             changed (`reuse_matmul_compact`); here the plain product, in
             torch ops as the reference's is jnp outside any kernel.
  "dense"  — the masked product `reuse_matmul_ref` in torch ops, as the
             reference computes it outside any kernel (the guard's oracle).
`reuse_matmul_masked` is the branchless software-reuse product (full work,
the paper's negative result), also in torch ops.

Beside them: the int8 split GEMM (`reuse_matmul_int8`, exact int32, fed by
`core.delta.delta_encode_int8`), the RWKV6 recurrence step (`wkv6_decode`,
which updates its state in place) and a site call's cache bookkeeping after
its GEMM (`site_account`, in place on the cache entry; a reuse-mode call
takes it fused into its delta/quant/mask pass, `delta_quant_account`).

`impl` picks the substrate: "cuda" calls the kernel wrappers, which launch
the Hopper kernels on CUDA tensors (and take the plain versions on CPU
tensors); "torch" calls the plain versions directly, on any device.

The accounting functions (`clamp_budget`, `ragged_dma_tiles`,
`ragged_grid_steps`, `budget_overflow` from `kernels/site_account.py`, and
`weight_dma_tiles` from the kernel module) are the reference's, ported
exactly: `site_account`'s plain version computes the sensor's
`dma_issued_tiles`, `grid_steps` and `overflow_fallbacks` with them, and its
kernel computes the same values, bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.delta import compact_rows
from repro_torch.kernels import delta_quant as _dq
from repro_torch.kernels import reuse_matmul as _rm
from repro_torch.kernels import reuse_matmul_int8 as _ri
from repro_torch.kernels import reuse_matmul_ragged as _rr
from repro_torch.kernels import site_account as _sa
from repro_torch.kernels import wkv6_decode as _wkv
from repro_torch.kernels.ref import (
    delta_quant_ref,
    reuse_matmul_int8_ref,
    reuse_matmul_ref,
)
from repro_torch.kernels.reuse_matmul import skip_sel, weight_dma_tiles
from repro_torch.kernels.site_account import (
    budget_overflow,
    clamp_budget,
    ragged_dma_tiles,
    ragged_grid_steps,
)

__all__ = [
    "budget_overflow",
    "clamp_budget",
    "compact_rows",
    "delta_quant_account",
    "delta_quant_fused",
    "delta_quant_ref",
    "f32_product",
    "ragged_dma_tiles",
    "ragged_grid_steps",
    "reuse_matmul",
    "reuse_matmul_compact",
    "reuse_matmul_int8",
    "reuse_matmul_int8_ref",
    "reuse_matmul_masked",
    "reuse_matmul_ragged",
    "reuse_matmul_ref",
    "site_account",
    "skip_sel",
    "weight_dma_tiles",
    "wkv6_decode",
]

IMPLS = ("cuda", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def _pad_to(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % mult0
    p1 = (-x.shape[1]) % mult1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def reuse_matmul(
    delta: torch.Tensor,
    w: torch.Tensor,
    prev_out: torch.Tensor,
    block_mask: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
    dataflow: str = "output",
    impl: str = "cuda",
    n_total: int | None = None,
) -> torch.Tensor:
    """Padded entry to the block-skip GEMM (masked full grid). Δ and
    prev_out are padded to whole tiles in M, Δ in K; the weight never (the
    kernels read the last k tile's rows past K and the last n tile's
    columns past N as zero), so no site copies its weight. `w` may be a
    model-axis shard's column panel of the site's weight, read in place;
    `n_total` (the unsharded site's N) then sets the kernel's k split."""
    _check_impl(impl)
    m, n = prev_out.shape
    dp = _pad_to(delta, block_m, block_k)
    pp = _pad_to(prev_out.float(), block_m, 1)
    gm, gk = dp.shape[0] // block_m, dp.shape[1] // block_k
    if tuple(block_mask.shape) != (gm, gk):
        raise ValueError(f"mask {tuple(block_mask.shape)} != {(gm, gk)}")
    if impl == "cuda":
        out = _rm.reuse_matmul(
            dp, w, pp, block_mask.contiguous(), block_m=block_m,
            block_n=block_n, block_k=block_k, dataflow=dataflow,
            n_total=n_total,
        )
    else:
        out = _rm.reuse_matmul_torch(dp, w, pp, block_mask,
                                     block_m=block_m, block_k=block_k)
    return out[:m, :n]


def reuse_matmul_int8(
    delta_q: torch.Tensor,     # [M, K] int8 (lo or hi of delta_encode_int8)
    w_q: torch.Tensor,         # [K, N] int8
    prev_acc: torch.Tensor,    # [M, N] int32
    block_mask: torch.Tensor,  # [gm, gk] int32 of the padded operands
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
    impl: str = "cuda",
) -> torch.Tensor:
    """Padded entry to the int8 block-skip GEMM (exact int32 result)."""
    _check_impl(impl)
    m, n = prev_acc.shape
    dp = _pad_to(delta_q, block_m, block_k)
    wp = _pad_to(w_q, block_k, block_n)
    pp = _pad_to(prev_acc, block_m, block_n)
    gm, gk = dp.shape[0] // block_m, dp.shape[1] // block_k
    if tuple(block_mask.shape) != (gm, gk):
        raise ValueError(f"mask {tuple(block_mask.shape)} != {(gm, gk)}")
    if impl == "cuda":
        out = _ri.reuse_matmul_int8(dp, wp, pp, block_mask.contiguous(),
                                    block_m=block_m, block_n=block_n,
                                    block_k=block_k)
    else:
        out = _ri.reuse_matmul_int8_torch(dp, wp, pp, block_mask,
                                          block_m=block_m, block_k=block_k)
    return out[:m, :n]


def wkv6_decode(
    r: torch.Tensor,      # [B, H, dk]
    k: torch.Tensor,      # [B, H, dk]
    v: torch.Tensor,      # [B, H, dv]
    w: torch.Tensor,      # [B, H, dk] decay in (0, 1)
    u: torch.Tensor,      # [H, dk] bonus
    state: torch.Tensor,  # [B, H, dk, dv] f32, updated IN PLACE
    *,
    impl: str = "cuda",
) -> torch.Tensor:
    """One RWKV6 recurrence step. Returns out [B, H, dv] f32 and writes the
    new state into `state` on both substrates."""
    _check_impl(impl)
    r, k, v, w, u = (a.contiguous() for a in (r, k, v, w, u))
    if impl == "cuda":
        out, _ = _wkv.wkv6_decode(r, k, v, w, u, state)
        return out
    out, s_new = _wkv.wkv6_decode_torch(r, k, v, w, u, state)
    state.copy_(s_new)
    return out


def reuse_matmul_ragged(
    delta: torch.Tensor,       # [M, K]
    w: torch.Tensor,           # [K, N]
    prev_out: torch.Tensor,    # [M, N]
    block_mask: torch.Tensor,  # [gm, gk] int32; 1 = compute tile
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
    impl: str = "cuda",
    compacted: tuple[torch.Tensor, torch.Tensor] | None = None,  # (idx, counts)
    n_total: int | None = None,
) -> torch.Tensor:
    """Padded entry to the ragged compacted-walk GEMM (the weight never
    padded, a column panel read in place, as `reuse_matmul`).

    The reference grid has the static extent `max_active_k` and falls back to
    the full extent when a row's live count overflows it; either way it adds
    exactly each row's active tiles. The kernel (and its plain twin) walks
    `counts[m]` of the full-extent `idx`, which adds the same tiles with no
    budget and no host branch, so the budget only enters the accounting
    (`ragged_grid_steps`, `budget_overflow`). `compacted` threads a
    precomputed `compact_rows(block_mask)`.
    """
    _check_impl(impl)
    m, n = prev_out.shape
    dp = _pad_to(delta, block_m, block_k)
    pp = _pad_to(prev_out.float(), block_m, 1)
    gm, gk = dp.shape[0] // block_m, dp.shape[1] // block_k
    if tuple(block_mask.shape) != (gm, gk):
        raise ValueError(f"mask {tuple(block_mask.shape)} != {(gm, gk)}")
    idx, counts = compact_rows(block_mask) if compacted is None else compacted
    if impl == "cuda":
        out = _rr.reuse_matmul_ragged(dp, w, pp, counts, idx,
                                      block_m=block_m, block_n=block_n,
                                      block_k=block_k, n_total=n_total)
    else:
        out = _rr.reuse_matmul_ragged_torch(dp, w, pp, counts, idx,
                                            block_m=block_m, block_n=block_n,
                                            block_k=block_k)
    return out[:m, :n]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 product with an f32 output ([M,K]x[K,N] or batched)."""
    mm = torch.bmm if a.ndim == 3 else torch.mm
    return mm(a, b, out_dtype=torch.float32)


def _split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g (f32) as hi + lo, two bf16 tensors: 16 bits of g's 24-bit mantissa,
    so a product with a bf16 operand keeps g to a relative 2^-16."""
    hi = g.to(torch.bfloat16)
    return hi, (g - hi.float()).to(torch.bfloat16)


class _BF16ProductF32(torch.autograd.Function):
    """a @ b of two bf16 tensors with an f32 result, and its gradient, which
    `aten::mm.dtype` lacks. The backward products keep both operands in
    bf16 (the weight is never widened): the f32 cotangent is split into a
    bf16 pair (`_split_bf16`), each half multiplied with an f32 output, so
    the gradient is the f32 product's to about 2^-16 of its terms; each
    gradient is rounded once to bf16, its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        hi, lo = _split_bf16(g.float().contiguous())
        ga = gb = None
        if ctx.needs_input_grad[0]:
            bt = b.transpose(-1, -2)
            ga = (_mm_f32(hi, bt) + _mm_f32(lo, bt)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.transpose(-1, -2)
            gb = (_mm_f32(at, hi) + _mm_f32(at, lo)).to(b.dtype)
        return ga, gb


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, the reference's preferred_element_type=f32
    product outside any kernel ([M,K]x[K,N], or batched [E,M,K]x[E,K,N]). On
    the card a bf16 pair is one bf16 product with an f32 output, so the
    weight is never widened, with its gradient (`_BF16ProductF32`);
    elsewhere (the CPU twin, f32 models) both operands are taken to f32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _BF16ProductF32.apply(a, b)
        return _mm_f32(a, b)
    return a.float() @ b.float()


def reuse_matmul_compact(
    delta: torch.Tensor,         # [M, K]
    w: torch.Tensor,             # [K, N]
    prev_out: torch.Tensor,      # [M, N]
    k_block_mask: torch.Tensor,  # [ceil(K/block_k)] int32: any row changed
    *,
    block_k: int = 256,
) -> torch.Tensor:
    """The compaction path: prev_out (f32) + Δ·W.

    The reference gathers the live K-blocks of Δ and W in compacted order,
    `max_blocks` of them or, when the live count overflows that budget, the
    full extent, a data-dependent branch. Δ is zero in every block whose
    mask bit is 0 (the bits come from the same fused pass), so the product
    over all of K has the same terms as either branch, in another summation
    order, with no gather and no host branch. The budget enters only the
    accounting (`ragged_grid_steps`, `budget_overflow`)."""
    gk = -(-delta.shape[1] // block_k)
    if tuple(k_block_mask.shape) != (gk,):
        raise ValueError(f"k mask {tuple(k_block_mask.shape)} != {(gk,)}")
    return prev_out.float() + f32_product(delta, w)


def reuse_matmul_masked(
    delta: torch.Tensor, w: torch.Tensor, prev_out: torch.Tensor
) -> torch.Tensor:
    """Software reuse, branchless: prev_out + where(Δ != 0, Δ, 0)·W with an
    f32 result. All the delta bookkeeping and none of the skipping: the full
    product runs, which is the paper's Sec.-III negative result. Plain torch
    ops, as the reference's is jnp outside any kernel."""
    d = torch.where(delta != 0, delta, torch.zeros_like(delta))
    return prev_out + f32_product(d, w)


def delta_quant_fused(
    x: torch.Tensor,
    prev_q: torch.Tensor,
    scale: torch.Tensor,
    *,
    block_m: int = 128,
    block_k: int = 256,
    delta_dtype: torch.dtype = torch.bfloat16,
    impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded entry to the fused delta/quant/mask pass. Padding is zeros in
    both x and prev_q, so padded positions never set a mask bit."""
    _check_impl(impl)
    m, k = x.shape
    xp = _pad_to(x, block_m, block_k)
    pq = _pad_to(prev_q, block_m, block_k)
    fn = _dq.delta_quant if impl == "cuda" else _dq.delta_quant_torch
    q, delta, mask = fn(xp, pq, scale, block_m=block_m, block_k=block_k,
                        delta_dtype=delta_dtype)
    return q[:m, :k], delta[:m, :k], mask


def site_account(
    cur_q: torch.Tensor,                # [M, K] int8, this call's codes
    block_mask: torch.Tensor | None,    # [gm, gk] int32; None: basic mode
    cache: dict,                        # the site's entry (or shard lane)
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
    shard=None,
    impl: str = "cuda",
) -> torch.Tensor:
    """A site call's cache bookkeeping after its GEMM, in place on `cache`:
    the match counts and the `prev_q` write, `sim_ema`, `steps`, the ctrl
    occupancy (reuse mode) and the sensor counters of `path` (a sharded
    call's with `shard`). `budget` is the ragged and compact accounting's
    k-extent budget: the engine's budget lane, or the spec's Python int.
    Returns the per-row match counts, [M] f32."""
    _check_impl(impl)
    fn = _sa.site_account if impl == "cuda" else _sa.site_account_torch
    return fn(cur_q, block_mask, cache, path=path, dataflow=dataflow,
              block_m=block_m, block_k=block_k, n=n, gn=gn,
              w_itemsize=w_itemsize, ema_decay=ema_decay, budget=budget,
              shard=shard)


def delta_quant_account(
    x: torch.Tensor,        # [M, K] f32 / bf16, unpadded
    cache: dict,            # the site's entry (or shard lane)
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
    shard=None,
    impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A reuse-mode site call's delta/quant/mask pass with its bookkeeping:
    `delta_quant_fused` against the entry's prev_q, then `site_account` on
    the codes, as one kernel on the card. Writes prev_q and every lane in
    place, in the entry's own tensors; returns (delta [M, K], mask
    [gm, gk] int32, matches [M] f32)."""
    _check_impl(impl)
    fn = (_sa.delta_quant_account if impl == "cuda"
          else _sa.delta_quant_account_torch)
    return fn(x, cache, block_m=block_m, block_k=block_k,
              delta_dtype=delta_dtype, path=path, dataflow=dataflow, n=n,
              gn=gn, w_itemsize=w_itemsize, ema_decay=ema_decay,
              budget=budget, shard=shard)
