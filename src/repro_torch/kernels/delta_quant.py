"""Fused quantize + delta + tile-mask pass (kernel 1 of the reuse decode path).

    cur_q = clip(round(x / scale), ±127)        int8 codes, written to the cache
    delta = (cur_q − prev_q) · scale            exact zero where codes match
    mask[m, k] = any(delta tile != 0)           one int32 per (bm × bk) tile

`delta_quant` launches `csrc/delta_quant.cu` on CUDA tensors (its 8-wide
vector instance where `vector_access` allows, else its scalar instance) and
takes the plain twin `delta_quant_torch` (the counterpart of the reference's
`xla_tier.delta_quant_xla`) on CPU tensors. Operands are tile multiples; the
padding entry is `ops.delta_quant_fused`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend


def delta_quant_torch(
    x: torch.Tensor,
    prev_q: torch.Tensor,
    scale: torch.Tensor,
    *,
    block_m: int,
    block_k: int,
    delta_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the same elementwise chain, op for op."""
    m, k = x.shape
    gm, gk = m // block_m, k // block_k
    s = scale.float()
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    dq = q.to(torch.int32) - prev_q.to(torch.int32)
    cur_q = q.to(torch.int8)
    delta = (dq.float() * s).to(delta_dtype)
    tiles = dq.reshape(gm, block_m, gk, block_k)
    mask = (tiles != 0).any(dim=3).any(dim=1).to(torch.int32)
    return cur_q, delta, mask


def vector_access(ptrs, block_k: int) -> bool:
    """Whether the kernel's 8-wide vector instance can take these operands:
    every pointer 16-byte aligned and block_k a multiple of 8 (so every row
    and tile starts aligned). Views at a storage offset can miss this; they
    take the scalar instance of the same kernel."""
    return block_k % 8 == 0 and all(p % 16 == 0 for p in ptrs)


def _check(x, prev_q, scale, block_m, block_k, delta_dtype) -> None:
    dev = x.device
    if x.dtype not in backend.DTYPE_CODE or delta_dtype not in backend.DTYPE_CODE:
        raise TypeError(f"delta_quant: x {x.dtype} / delta {delta_dtype} "
                        "must be float32 or bfloat16")
    if prev_q.dtype != torch.int8 or prev_q.shape != x.shape:
        raise TypeError(f"delta_quant: prev_q {prev_q.dtype} {tuple(prev_q.shape)}"
                        f" must be int8 {tuple(x.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("delta_quant: scale must be one float32")
    for name, t in (("x", x), ("prev_q", prev_q), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"delta_quant: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"delta_quant: {name} must be contiguous")


def delta_quant(
    x: torch.Tensor,        # [M, K] f32 / bf16, tile multiples
    prev_q: torch.Tensor,   # [M, K] int8
    scale: torch.Tensor,    # f32 scalar, on x's device
    *,
    block_m: int = 128,
    block_k: int = 256,
    delta_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (cur_q int8 [M,K], delta [M,K] delta_dtype, mask int32 [gm,gk])."""
    m, k = x.shape
    if m % block_m or k % block_k:
        raise ValueError(f"delta_quant: {tuple(x.shape)} not a multiple of "
                         f"({block_m}, {block_k}); pad with ops.delta_quant_fused")
    if x.device.type == "cpu":
        return delta_quant_torch(x, prev_q, scale, block_m=block_m,
                                 block_k=block_k, delta_dtype=delta_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"delta_quant: unsupported device {x.device}")
    _check(x, prev_q, scale, block_m, block_k, delta_dtype)
    gm, gk = m // block_m, k // block_k
    q = torch.empty_like(prev_q)
    delta = torch.empty((m, k), dtype=delta_dtype, device=x.device)
    mask = torch.empty((gm, gk), dtype=torch.int32, device=x.device)
    ptrs = (x.data_ptr(), prev_q.data_ptr(), q.data_ptr(), delta.data_ptr())
    rc = backend.library("delta_quant").rt_delta_quant(
        ptrs[0], backend.DTYPE_CODE[x.dtype], ptrs[1], scale.data_ptr(),
        ptrs[2], ptrs[3], backend.DTYPE_CODE[delta_dtype], mask.data_ptr(),
        m, k, block_m, block_k, int(vector_access(ptrs, block_k)),
        backend.stream_ptr(x.device),
    )
    backend.check(rc, "delta_quant")
    backend.count_launch("delta_quant")
    return q, delta, mask
