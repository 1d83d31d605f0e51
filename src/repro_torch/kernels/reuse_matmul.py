"""Block-skip ΔW GEMM, both dataflows (kernels 2 and 3 of the decode path).

    O_c = O_p + Σ_k mask[m, k] · Δ[m, k] · W[k, n]        f32 accumulation

A masked (m, k) tile costs neither its weight load nor its FMAs — the
paper's "skipping weight loads" and "bypassing computations". `reuse_matmul`
launches `csrc/reuse_matmul.cu` on CUDA tensors (output- or input-stationary,
a property of the site) and takes `reuse_matmul_torch`, the counterpart of
the reference's `xla_tier.reuse_matmul_xla`, on CPU tensors.

`skip_sel` and `weight_dma_tiles` are the reference's accounting of weight
tiles a TPU grid walk issues under this kernel's semantics, ported exactly:
the sensor's `dma_issued_tiles` counter comes from them, not from the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend

ROWS_PER_CTA = 8     # csrc/reuse_tile.cuh kRows
COLS_PER_CTA = 128   # csrc/reuse_tile.cuh kCols
SUB_K = 64           # k rows of one sub-step, csrc/reuse_tile.cuh kSubK
CLUSTERS = (1, 2, 4, 8)  # k splits the kernels launch
SM_FILL = 0.875      # share of the SMs k_split gives at least one CTA


def k_split(m: int, n: int, k: int, n_sm: int) -> int:
    """Cluster size C that splits each (8-row, 128-column) output tile's k
    range in the output-stationary and ragged kernels: the smallest C in
    CLUSTERS whose (n / 128) · (m / 8) · C CTAs reach SM_FILL · n_sm, and at
    most the tile's k / SUB_K sub-steps. From the shape alone: the active
    count lives on the device and is never read. On the H100 one CTA an SM
    already streams at the card's rate and each further split costs its own
    ring fill and reduction, so more CTAs only lose (PERF.md §6)."""
    tiles = (n // COLS_PER_CTA) * (m // ROWS_PER_CTA)
    fits = [c for c in CLUSTERS if c <= max(1, k // SUB_K)]
    for c in fits:
        if tiles * c >= SM_FILL * n_sm:
            return c
    return fits[-1]


def skip_sel(block_mask: torch.Tensor) -> torch.Tensor:
    """sel[m, k] = index of the newest non-skipped k'-block with k' <= k
    (cold prefix clamps to 0) — the TPU kernel's DMA-suppressing index."""
    gm, gk = block_mask.shape
    ks = torch.arange(gk, dtype=torch.int32, device=block_mask.device)[None, :]
    marked = torch.where(block_mask != 0, ks, torch.full_like(ks, -1))
    sel = torch.cummax(marked, dim=1).values
    return torch.clamp(sel, min=0).to(torch.int32)


def weight_dma_tiles(
    block_mask: torch.Tensor,
    *,
    gn: int,
    dataflow: str = "output",
    sel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weight-tile loads issued under the kernel's sel semantics (int32).

    * output-stationary: per (m, n) panel one load at k = 0 plus one per sel
      transition;
    * input-stationary: a computed (m, k) tile sweeps gn weight tiles.
    """
    if sel is None:
        sel = skip_sel(block_mask)
    if dataflow == "output":
        transitions = (sel[:, 1:] != sel[:, :-1]).sum(dtype=torch.int32)
        rows = block_mask.shape[0]
        return (transitions + rows) * gn
    return (block_mask != 0).sum(dtype=torch.int32) * gn


def expand_block_mask(
    block_mask: torch.Tensor, m: int, k: int, block_m: int, block_k: int
) -> torch.Tensor:
    """[gm, gk] tile mask -> [M, K] elementwise {0, 1} f32 mask."""
    em = torch.repeat_interleave(block_mask, block_m, dim=0)[:m]
    return torch.repeat_interleave(em, block_k, dim=1)[:, :k].float()


def check_k_tail(k: int, kw: int, block_k: int, what: str) -> None:
    """The weight's rows against Δ's columns: Δ is padded to whole block_k
    tiles and the weight keeps its own kw rows, the last tile's rows past kw
    reading as zero (K − block_k < kw ≤ K), so no call copies the weight."""
    if not k - block_k < kw <= k:
        raise ValueError(f"{what}: w has {kw} rows, delta {k} columns in "
                         f"tiles of {block_k}")


def reuse_matmul_torch(
    delta: torch.Tensor,       # [M, K]
    w: torch.Tensor,           # [Kw, N], Kw <= K
    prev_out: torch.Tensor,    # [M, N] f32
    block_mask: torch.Tensor,  # [gm, gk] int32
    *,
    block_m: int,
    block_k: int,
) -> torch.Tensor:
    """Plain version: O_c = O_p + (Δ ⊙ mask) @ W in f32 (Δ's columns past
    W's rows are its zero padding; W may be a column panel)."""
    m, k = delta.shape
    d = delta.float() * expand_block_mask(block_mask, m, k, block_m, block_k)
    return prev_out + d[:, :w.shape[0]] @ w.float()


def check_gemm(delta, w, prev_out, block_m, block_k, block_n, what) -> None:
    """Device, dtype, shape, contiguity, alignment and tiling checks of the
    ΔW GEMM kernels (shared with reuse_matmul_ragged). Each CUDA CTA covers
    ROWS_PER_CTA rows of one block_m group and COLS_PER_CTA columns (the
    last tile column may end inside the tile: the N tail) and deals k out
    in sub-steps of SUB_K rows. The weight may be a column panel of a wider
    weight (a model-axis shard's `w[:, s·N:(s+1)·N]`), read in place with
    its row stride: its base, its row stride and its N must be 16-byte
    aligned (N % 8 == 0 in bf16). A broken divisor or alignment raises
    ValueError naming it, before any launch."""
    dev = delta.device
    if delta.dtype not in backend.DTYPE_CODE or w.dtype != delta.dtype:
        raise TypeError(f"{what}: delta {delta.dtype} and w {w.dtype} must "
                        "share one of float32, bfloat16")
    if prev_out.dtype != torch.float32:
        raise TypeError(f"{what}: prev_out must be float32, got {prev_out.dtype}")
    m, k = delta.shape
    if tuple(prev_out.shape) != (m, w.shape[1]):
        raise ValueError(f"{what}: shapes {tuple(delta.shape)} "
                         f"{tuple(w.shape)} {tuple(prev_out.shape)}")
    check_k_tail(k, w.shape[0], block_k, what)
    for name, size, div in (("block_m", block_m, ROWS_PER_CTA),
                            ("block_n", block_n, COLS_PER_CTA),
                            ("block_k", block_k, SUB_K)):
        if size % div:
            raise ValueError(f"{what}: the CUDA kernel needs {name} % {div} "
                             f"== 0, got {name} = {size}")
    for name, t in (("delta", delta), ("w", w), ("prev_out", prev_out)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, delta on {dev}")
    for name, t in (("delta", delta), ("prev_out", prev_out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    vec = 16 // w.element_size()
    if w.shape[1] and (w.stride(1) != 1 or w.stride(0) < w.shape[1]):
        raise ValueError(f"{what}: w must be row-major (a column panel of a "
                         f"weight), got strides {tuple(w.stride())}")
    if w.data_ptr() % 16 or w.stride(0) % vec or w.shape[1] % vec:
        raise ValueError(f"{what}: w's base, row stride {w.stride(0)} and "
                         f"columns {w.shape[1]} must be 16-byte aligned "
                         f"(multiples of {vec} elements)")


def ldw(w: torch.Tensor) -> int:
    """The weight's row stride in elements, as the kernels read it."""
    return w.stride(0) if w.shape[0] > 1 else w.shape[1]


def reuse_matmul(
    delta: torch.Tensor,       # [M, K] bf16/f32 — zero wherever codes matched
    w: torch.Tensor,           # [Kw, N], K - block_k < Kw <= K
    prev_out: torch.Tensor,    # [M, N] f32
    block_mask: torch.Tensor,  # [gm, gk] int32
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
    dataflow: str = "output",
    n_total: int | None = None,
) -> torch.Tensor:
    """O_c = O_p + Δ·W, skipping weight loads and FMAs for zero tiles.
    Δ is a tile multiple in M and K; the weight's rows may end inside the
    last k tile (`check_k_tail`) and its columns inside the last n tile
    (the N tail); the padding entry is `ops.reuse_matmul`. `w` may be a
    column panel of a wider weight (`check_gemm`); `n_total`, the
    unsharded site's N, then picks the k split, so every panel sums each
    output element in the unsharded order."""
    m, k = delta.shape
    n = w.shape[1]
    if m % block_m or k % block_k:
        raise ValueError(f"reuse_matmul: ({m}, {k}) not a multiple of "
                         f"({block_m}, {block_k}); pad with ops")
    check_k_tail(k, w.shape[0], block_k, "reuse_matmul")
    gm, gk = m // block_m, k // block_k
    if tuple(block_mask.shape) != (gm, gk):
        raise ValueError(f"reuse_matmul: mask {tuple(block_mask.shape)} != "
                         f"{(gm, gk)}")
    if dataflow not in ("output", "input"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if delta.device.type == "cpu":
        return reuse_matmul_torch(delta, w, prev_out, block_mask,
                                  block_m=block_m, block_k=block_k)
    if delta.device.type != "cuda":
        raise ValueError(f"reuse_matmul: unsupported device {delta.device}")
    check_gemm(delta, w, prev_out, block_m, block_k, block_n,
               f"reuse_matmul({dataflow})")
    if block_mask.dtype != torch.int32 or block_mask.device != delta.device \
            or not block_mask.is_contiguous():
        raise ValueError("reuse_matmul: block_mask must be contiguous int32 "
                         "on the operands' device")
    lib = backend.library("reuse_matmul")
    out = torch.empty_like(prev_out)
    code = backend.DTYPE_CODE[delta.dtype]
    stream = backend.stream_ptr(delta.device)
    # one launch: clusters of CTAs split each tile's active k range and sum
    # their partials on chip, so no scratch is allocated
    if dataflow == "output":
        cluster = k_split(m, n_total or n, k,
                          backend.sm_count(delta.device.index))
        rc = lib.rt_reuse_matmul_output(
            delta.data_ptr(), w.data_ptr(), code, prev_out.data_ptr(),
            block_mask.data_ptr(), out.data_ptr(), m, k, w.shape[0], n,
            ldw(w), block_m, block_k, cluster, stream,
        )
        backend.check(rc, "reuse_matmul(output)")
        backend.count_launch("reuse_matmul_output")
        return out
    rc = lib.rt_reuse_matmul_input(
        delta.data_ptr(), w.data_ptr(), code, prev_out.data_ptr(),
        block_mask.data_ptr(), out.data_ptr(), m, k, w.shape[0], n, ldw(w),
        block_m, block_k, stream,
    )
    backend.check(rc, "reuse_matmul(input)")
    backend.count_launch("reuse_matmul_input")
    return out
