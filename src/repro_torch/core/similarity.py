"""Input similarity in the int8 code domain, and the tile-granular change mask.

Similarity between two consecutive evaluations of a layer is the fraction of
identical int8 codes at matching positions. The skip granularity of the reuse
GEMM is a (block_m × block_k) tile, so `block_zero_mask` marks the tiles with
any changed code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def row_code_similarity(cur_q: torch.Tensor, prev_q: torch.Tensor) -> torch.Tensor:
    """Per-row code-match fraction, [M] f32 — one similarity per serving slot.
    The exact match count times the f32 reciprocal of K, as XLA lowers the
    reference's mean (bitwise equal to it)."""
    count = (cur_q == prev_q).sum(dim=-1, dtype=torch.float32)
    return count * (1.0 / cur_q.shape[-1])


def block_zero_mask(delta: torch.Tensor, block_m: int, block_k: int) -> torch.Tensor:
    """int32 [ceil(M/bm), ceil(K/bk)]: 1 where the tile has any nonzero entry.

    M and K are padded virtually; padding positions count as unchanged.
    """
    m, k = delta.shape
    pm = (-m) % block_m
    pk = (-k) % block_k
    if pm or pk:
        delta = F.pad(delta, (0, pk, 0, pm))
    gm, gk = delta.shape[0] // block_m, delta.shape[1] // block_k
    tiles = delta.reshape(gm, block_m, gk, block_k)
    return (tiles != 0).any(dim=3).any(dim=1).to(torch.int32)


def ema_update(stat: torch.Tensor, obs: torch.Tensor, decay: float) -> torch.Tensor:
    """Running similarity estimate the reuse policy reads."""
    return decay * stat + (1.0 - decay) * obs
