"""Delta encoding (paper Eqns. 2-4): Δ = I_c − I_p in the int8 code domain.

Deltas are dequantized (scale · (q_c − q_p)) into the weight dtype, so zero
codes give exactly-zero deltas and tile skipping is exact. The compaction
helpers front-compact each m-row-block's active K-blocks for the ragged GEMM.

The int8 path (paper Sec. IV-B) keeps Δ in the code domain. The difference of
two int8 codes spans [−254, 254], so `delta_encode_int8` splits it into
lo = clip(Δ, −127, 127) and hi = Δ − lo, both in int8 range; the hi GEMM runs
through the same block-skip kernel and its near-empty mask makes it nearly
free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.similarity import block_zero_mask
from repro_torch.quant import quantize_int8


class DeltaEncoding(NamedTuple):
    delta: torch.Tensor          # float delta in the weight dtype, [M, K]
    cur_q: torch.Tensor          # int8 codes of the current input, [M, K]
    block_mask: torch.Tensor     # int32 [gm, gk]; 1 = tile must be computed
    skip_fraction: torch.Tensor  # f32 scalar: fraction of skippable tiles


def delta_encode(
    x: torch.Tensor,
    prev_q: torch.Tensor,
    scale: torch.Tensor,
    *,
    block_m: int,
    block_k: int,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> DeltaEncoding:
    """Quantize the current input, form the exact float delta and its tile mask."""
    cur_q = quantize_int8(x, scale)
    dq = cur_q.to(torch.int32) - prev_q.to(torch.int32)
    delta = (dq.float() * scale).to(compute_dtype)
    mask = block_zero_mask(dq, block_m, block_k)
    skip = 1.0 - torch.mean(mask.float())
    return DeltaEncoding(delta=delta, cur_q=cur_q, block_mask=mask,
                         skip_fraction=skip)


class Int8Delta(NamedTuple):
    lo: torch.Tensor            # int8 [M, K]
    hi: torch.Tensor            # int8 [M, K]; nonzero only where |Δ| > 127
    lo_mask: torch.Tensor       # int32 [gm, gk]
    hi_mask: torch.Tensor       # int32 [gm, gk] (≈ all zeros)
    has_overflow: torch.Tensor  # bool scalar


def delta_encode_int8(
    cur_q: torch.Tensor, prev_q: torch.Tensor, *, block_m: int, block_k: int
) -> Int8Delta:
    """The int8 delta with the overflow split: lo + hi = cur_q − prev_q."""
    dq = cur_q.to(torch.int32) - prev_q.to(torch.int32)
    lo = torch.clamp(dq, -127, 127)
    hi = dq - lo  # |hi| <= 127 because |dq| <= 254
    return Int8Delta(
        lo=lo.to(torch.int8),
        hi=hi.to(torch.int8),
        lo_mask=block_zero_mask(lo, block_m, block_k),
        hi_mask=block_zero_mask(hi, block_m, block_k),
        has_overflow=(hi != 0).any(),
    )


def compact_rows(block_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row front-compaction of a [gm, gk] tile mask.

    Returns (idx int32 [gm, gk], counts int32 [gm]): row m's first counts[m]
    entries are its active K-block ids in order; the tail repeats the last
    valid id, and a row with count 0 is all zeros.
    """
    gm, gk = block_mask.shape
    nz = block_mask != 0
    counts = nz.sum(dim=1, dtype=torch.int32)
    order = torch.cumsum(nz.to(torch.int64), dim=1) - 1
    # Inactive blocks scatter into a spare column that is dropped afterwards.
    target = torch.where(nz, order, torch.full_like(order, gk))
    ks = torch.arange(gk, dtype=torch.int32, device=block_mask.device)
    idx = torch.zeros((gm, gk + 1), dtype=torch.int32, device=block_mask.device)
    idx.scatter_(1, target, ks.expand(gm, gk).contiguous())
    idx = idx[:, :gk]
    last = torch.clamp(counts - 1, min=0).to(torch.int64)
    tail = torch.gather(idx, 1, last[:, None])
    idx = torch.where(ks[None, :] < counts[:, None], idx, tail)
    return idx.contiguous(), counts


def compact_block_indices(
    block_mask_row: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One row of `compact_rows`: (indices [gk], count)."""
    idx, counts = compact_rows(block_mask_row[None, :])
    return idx[0], counts[0]
