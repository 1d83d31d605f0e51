"""Int8 block-skip ΔW GEMM, exact in int32 (the paper's `mla8` analogue).

    acc = prev_acc + Σ_k mask[m, k] · Δq[m, k] · Wq[k, n]      int32

Δq is one component (lo or hi) of the overflow split of
`core.delta.delta_encode_int8`; the hi component's GEMM goes through the same
kernel and its near-empty mask makes it nearly free. `reuse_matmul_int8`
launches `csrc/reuse_matmul_int8.cu` (int8 tensor cores: `mma.sync` s8, and
`wgmma` s8 for 128-row tiles) on CUDA tensors and takes the plain version
`reuse_matmul_int8_torch` on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.reuse_matmul import expand_block_mask

# csrc/reuse_matmul_int8.cu: 8-row CTA tiles (128-row ones when block_m %
# 128 == 0), at most 128 columns wide, in 32-deep MMA steps (kGroupK, the
# skip's granularity)
ROWS_PER_CTA = 8
COLS_PER_CTA = 128
GROUP_K = 32


def reuse_matmul_int8_torch(
    delta_q: torch.Tensor,     # [M, K] int8
    w_q: torch.Tensor,         # [K, N] int8
    prev_acc: torch.Tensor,    # [M, N] int32
    block_mask: torch.Tensor,  # [gm, gk] int32
    *,
    block_m: int,
    block_k: int,
) -> torch.Tensor:
    """Plain version: prev_acc + (Δq ⊙ mask) @ Wq, exact. On the CPU the
    product is an int64 matmul; CUDA has no integer matmul, so there it runs
    in f64, which is exact here: every term is at most 127² and every sum
    stays far below 2⁵³."""
    m, k = delta_q.shape
    em = expand_block_mask(block_mask, m, k, block_m, block_k)
    if delta_q.device.type == "cpu":
        d = delta_q.long() * em.long()
        prod = d @ w_q.long()
    else:
        prod = (delta_q.double() * em.double()) @ w_q.double()
    return (prev_acc.long() + prod.long()).to(torch.int32)


def _check(delta_q, w_q, prev_acc, block_mask, block_m, block_n,
           block_k) -> None:
    dev = delta_q.device
    if delta_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"reuse_matmul_int8: delta_q {delta_q.dtype} and w_q "
                        f"{w_q.dtype} must be int8")
    if prev_acc.dtype != torch.int32 or block_mask.dtype != torch.int32:
        raise TypeError("reuse_matmul_int8: prev_acc and block_mask must be "
                        "int32")
    if block_m % ROWS_PER_CTA or block_n % COLS_PER_CTA or block_k % GROUP_K:
        raise ValueError(f"reuse_matmul_int8: the CUDA kernel needs block_m % "
                         f"{ROWS_PER_CTA} == 0, block_n % {COLS_PER_CTA} == 0 "
                         f"and block_k % {GROUP_K} == 0, got ({block_m}, "
                         f"{block_n}, {block_k})")
    for name, t in (("delta_q", delta_q), ("w_q", w_q),
                    ("prev_acc", prev_acc), ("block_mask", block_mask)):
        if t.device != dev:
            raise ValueError(f"reuse_matmul_int8: {name} on {t.device}, "
                             f"delta_q on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"reuse_matmul_int8: {name} must be contiguous "
                             "and 16-byte aligned")


def reuse_matmul_int8(
    delta_q: torch.Tensor,     # [M, K] int8 (lo or hi component)
    w_q: torch.Tensor,         # [K, N] int8
    prev_acc: torch.Tensor,    # [M, N] int32
    block_mask: torch.Tensor,  # [gm, gk] int32
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
) -> torch.Tensor:
    """acc = prev_acc + Δq·Wq in int32, skipping weight loads and MACs of
    masked tiles. Operands are tile multiples; the padding entry is
    `ops.reuse_matmul_int8`."""
    m, k = delta_q.shape
    n = w_q.shape[1]
    if m % block_m or k % block_k or n % block_n:
        raise ValueError(f"reuse_matmul_int8: ({m}, {k}, {n}) not a multiple "
                         f"of ({block_m}, {block_k}, {block_n}); pad with ops")
    if w_q.shape[0] != k or tuple(prev_acc.shape) != (m, n):
        raise ValueError(f"reuse_matmul_int8: shapes {tuple(delta_q.shape)} "
                         f"{tuple(w_q.shape)} {tuple(prev_acc.shape)}")
    if tuple(block_mask.shape) != (m // block_m, k // block_k):
        raise ValueError(f"reuse_matmul_int8: mask {tuple(block_mask.shape)} "
                         f"!= {(m // block_m, k // block_k)}")
    if delta_q.device.type == "cpu":
        return reuse_matmul_int8_torch(delta_q, w_q, prev_acc, block_mask,
                                       block_m=block_m, block_k=block_k)
    if delta_q.device.type != "cuda":
        raise ValueError(f"reuse_matmul_int8: unsupported device "
                         f"{delta_q.device}")
    _check(delta_q, w_q, prev_acc, block_mask, block_m, block_n, block_k)
    out = torch.empty_like(prev_acc)
    rc = backend.library("reuse_matmul_int8").rt_reuse_matmul_int8(
        delta_q.data_ptr(), w_q.data_ptr(), prev_acc.data_ptr(),
        block_mask.data_ptr(), out.data_ptr(), m, k, n, block_m, block_k,
        backend.stream_ptr(delta_q.device),
    )
    backend.check(rc, "reuse_matmul_int8")
    backend.count_launch("reuse_matmul_int8")
    return out
