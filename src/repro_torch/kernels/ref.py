"""Oracles for the reuse kernels, as `repro.kernels.ref`. `reuse_matmul_ref`
is also the product of the "dense" exec path, as in the reference.

The block-skip GEMM oracle applies the mask explicitly: tiles whose bit is 0
contribute nothing. When the mask comes from the delta (its only producer on
the serve path), masked tiles are all-zero anyway and the oracle equals
`prev_out + delta @ w`.
"""

from __future__ import annotations

import torch

from repro_torch.core.similarity import block_zero_mask
from repro_torch.kernels.reuse_matmul import expand_block_mask


def reuse_matmul_ref(
    delta: torch.Tensor,       # [M, K] float
    w: torch.Tensor,           # [K, N] float
    prev_out: torch.Tensor,    # [M, N] f32
    block_mask: torch.Tensor,  # [gm, gk] int32; 1 = compute tile
    block_m: int,
    block_k: int,
) -> torch.Tensor:
    """O_c = O_p + (Δ ⊙ mask) @ W with f32 accumulation."""
    m, k = delta.shape
    d = delta.float() * expand_block_mask(block_mask, m, k, block_m, block_k)
    return prev_out + d @ w.float()


def reuse_matmul_int8_ref(
    delta_q: torch.Tensor,     # [M, K] int8
    w_q: torch.Tensor,         # [K, N] int8
    prev_acc: torch.Tensor,    # [M, N] int32
    block_mask: torch.Tensor,  # [gm, gk] int32
    block_m: int,
    block_k: int,
) -> torch.Tensor:
    """Int8 × int8 → int32 accumulate variant (the mla8 analogue), computed
    in int64 and narrowed."""
    m, k = delta_q.shape
    em = expand_block_mask(block_mask, m, k, block_m, block_k).long()
    d = delta_q.long() * em
    return (prev_acc.long() + d @ w_q.long()).to(torch.int32)


def wkv6_decode_ref(r, k, v, w, u, state):
    """The RWKV6 recurrence step (the step body of the time mix). Returns
    (out [B, H, dv] f32, new state); `state` is not written."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       u[None, :, :, None].float() * kv + state)
    return out, wf[..., :, None] * state + kv


def delta_quant_ref(
    x: torch.Tensor,
    prev_q: torch.Tensor,
    scale: torch.Tensor,
    block_m: int,
    block_k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize + delta + tile mask. Returns (cur_q, delta_bf16, mask): like
    the reference oracle, the delta is always cast to bf16."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    cur_q = q.to(torch.int8)
    dq = cur_q.to(torch.int32) - prev_q.to(torch.int32)
    delta = (dq.float() * scale).to(torch.bfloat16)
    return cur_q, delta, block_zero_mask(dq, block_m, block_k)
