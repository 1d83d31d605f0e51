"""Ragged compacted-grid ΔW GEMM (kernel 4 of the decode path).

Per m-row-block, only the `counts[m]` front-compacted active K-blocks
`idx[m, :]` are walked, so a skipped tile costs no iteration; a row with
count 0 passes prev_out through. `reuse_matmul_ragged` launches
`csrc/reuse_matmul_ragged.cu` on CUDA tensors — the kernel walks
`counts[m]` on the device, so it needs no budget and no fallback, with each
tile's k range split over a cluster of `k_split` CTAs — and takes
`reuse_matmul_ragged_torch`, the counterpart of the reference's
`xla_tier.reuse_matmul_ragged_xla` (a gather GEMM over `idx`, guarded by
`counts`), on CPU tensors. Both take the full-extent `[gm, gk]` idx, so both
add exactly each row's `counts[m]` active tiles.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import backend
from repro_torch.kernels.reuse_matmul import (
    check_gemm,
    check_k_tail,
    k_split,
    ldw,
)


def reuse_matmul_ragged_torch(
    delta: torch.Tensor,     # [M, K] tile multiples
    w: torch.Tensor,         # [Kw, N], K - block_k < Kw <= K
    prev_out: torch.Tensor,  # [M, N] f32
    counts: torch.Tensor,    # [gm] int32
    idx: torch.Tensor,       # [gm, kb] int32
    *,
    block_m: int,
    block_n: int,
    block_k: int,
) -> torch.Tensor:
    """Plain version: gather each row's active Δ-blocks and the matching W
    row-blocks, guard the tail with j < counts[m], contract in f32. W's
    rows past its last (Δ's zero padding) are zeros here."""
    m, k = delta.shape
    n = w.shape[1]
    gm, gk = m // block_m, k // block_k
    kb = idx.shape[1]
    w = F.pad(w, (0, 0, 0, k - w.shape[0]))
    d_blk = delta.float().reshape(gm, block_m, gk, block_k).permute(0, 2, 1, 3)
    il = idx.to(torch.int64)
    d_g = torch.gather(
        d_blk, 1, il[:, :, None, None].expand(gm, kb, block_m, block_k))
    w_g = w.float().reshape(gk, block_k, n)[il]              # [gm, kb, bk, N]
    valid = (torch.arange(kb, device=idx.device)[None, :]
             < counts[:, None]).float()
    d_g = d_g * valid[:, :, None, None]
    upd = torch.einsum("gjab,gjbn->gan", d_g, w_g)
    out = prev_out.float().reshape(gm, block_m, n) + upd
    return out.reshape(m, n).to(prev_out.dtype)


def reuse_matmul_ragged(
    delta: torch.Tensor,
    w: torch.Tensor,
    prev_out: torch.Tensor,
    counts: torch.Tensor,
    idx: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
    n_total: int | None = None,
) -> torch.Tensor:
    """O_c = O_p + Δ·W over each row's compacted active k-blocks: the first
    counts[m] entries of the full-extent idx row. `w` may be a column panel
    with an N tail, and `n_total` picks the k split, as in
    `reuse_matmul.reuse_matmul`."""
    m, k = delta.shape
    n = w.shape[1]
    if m % block_m or k % block_k:
        raise ValueError(f"reuse_matmul_ragged: ({m}, {k}) not a multiple"
                         f" of ({block_m}, {block_k}); pad with ops")
    check_k_tail(k, w.shape[0], block_k, "reuse_matmul_ragged")
    gm, gk = m // block_m, k // block_k
    if tuple(counts.shape) != (gm,) or tuple(idx.shape) != (gm, gk):
        raise ValueError(f"reuse_matmul_ragged: counts {tuple(counts.shape)} "
                         f"idx {tuple(idx.shape)}, want ({gm},) and "
                         f"({gm}, {gk})")
    if delta.device.type == "cpu":
        return reuse_matmul_ragged_torch(
            delta, w, prev_out, counts, idx,
            block_m=block_m, block_n=block_n, block_k=block_k,
        )
    if delta.device.type != "cuda":
        raise ValueError(f"reuse_matmul_ragged: unsupported device {delta.device}")
    check_gemm(delta, w, prev_out, block_m, block_k, block_n,
               "reuse_matmul_ragged")
    for name, t in (("counts", counts), ("idx", idx)):
        if t.dtype != torch.int32 or t.device != delta.device \
                or not t.is_contiguous():
            raise ValueError(f"reuse_matmul_ragged: {name} must be contiguous "
                             "int32 on the operands' device")
    out = torch.empty_like(prev_out)
    rc = backend.library("reuse_matmul_ragged").rt_reuse_matmul_ragged(
        delta.data_ptr(), w.data_ptr(), backend.DTYPE_CODE[delta.dtype],
        prev_out.data_ptr(), counts.data_ptr(), idx.data_ptr(), idx.stride(0),
        out.data_ptr(), m, k, w.shape[0], n, ldw(w), block_m, block_k,
        k_split(m, n_total or n, k, backend.sm_count(delta.device.index)),
        backend.stream_ptr(delta.device),
    )
    backend.check(rc, "reuse_matmul_ragged")
    backend.count_launch("reuse_matmul_ragged")
    return out
