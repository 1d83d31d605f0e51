"""Per-(slot, expert) delta reuse for routed MoE, as the JAX package's
`core.expert_reuse`.

Each decode slot keeps one cache lane per expert:

    prev_q     [E, B, d]    int8 codes of the last input slot b sent to e
    prev_hi    [E, B, 2f]   wi output for that input (pre-activation)
    prev_act_q [E, B, f]    activation codes, the wo site's input
    prev_out   [E, B, d]    wo output

Both expert linears are reuse sites: a slot that revisits expert e with the
same input codes has Δ = 0, so hi, the activation and out are unchanged,
and a partial match skips those weight tiles. On a lane's first touch the
output is the quantized dense one.

Δ = dq·scale with dq = cur_q − prev_q an integer in [−254, 254], exact in
bf16. The lane product is therefore taken as scale·(dq·W[e]): the codes
times every expert's weight in one batched product with an f32 result
(`ops.f32_product`; on the card bf16 operands, so the expert weights are
read once and never widened or gathered per slot), each slot keeping the
row of its own expert. Lanes are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.similarity import block_zero_mask
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm
from repro_torch.quant import quantize_int8


class ExpertReuseStats(NamedTuple):
    sticky_fraction: torch.Tensor  # P[slot's wi codes all matched its lane]
    wi_skip: torch.Tensor          # fraction of wi weight tiles skipped
    wo_skip: torch.Tensor


def init_expert_reuse_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zero lanes stacked over the layers ([L, E, B, ·]) and the two f32
    scales (0.05)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n = cfg.n_superblocks

    def zeros(width, dtype):
        return torch.zeros((n, e, batch, width), dtype=dtype, device=device)

    return {
        "prev_q": zeros(d, torch.int8),
        "prev_hi": zeros(2 * f, torch.float32),
        "prev_act_q": zeros(f, torch.int8),
        "prev_out": zeros(d, torch.float32),
        "scale": torch.tensor(0.05, dtype=torch.float32, device=device),
        "act_scale": torch.tensor(0.05, dtype=torch.float32, device=device),
    }


def layer_slice(cache: dict, i: int) -> dict:
    """One layer's lane view of the stacked cache (scales pass through)."""
    return {k: (v if k in ("scale", "act_scale") else v[i])
            for k, v in cache.items()}


def _lane_delta_product(dq: torch.Tensor, scale: torch.Tensor,
                        w: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Δ·W[top_e[b]] for each slot b, Δ = dq·scale: [B, N] f32."""
    e, b = w.shape[0], dq.shape[0]
    experts = torch.arange(e, device=dq.device)
    routed = (top_e[None, :] == experts[:, None])[..., None]    # [E, B, 1]
    codes = torch.where(routed, dq[None], torch.zeros_like(dq[None]))
    prod = ops.f32_product(codes.to(w.dtype), w)                 # [E, B, N]
    return prod[top_e, torch.arange(b, device=dq.device)] * scale


def moe_reuse_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,            # [B, 1, d] decode tokens
    cache: dict,                # one layer's slice of init_expert_reuse_cache
    *,
    block_k: int = 128,
) -> tuple[torch.Tensor, dict, ExpertReuseStats]:
    """Decode-step MoE with per-(slot, expert) delta reuse, top-1 routing.
    Returns (out [B, 1, d], the cache, updated in place, stats)."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError("expert reuse is a decode-step feature (S = 1)")
    h = apply_norm(p["norm"], x, cfg.norm_eps).reshape(b, d)

    logits = h.float() @ p["router"]
    top_e = torch.argmax(logits, dim=-1)                         # [B]
    slots = torch.arange(b, device=x.device)
    gate = torch.softmax(logits, dim=-1)[slots, top_e]
    idx = (top_e, slots)

    # wi site: Δ against this (slot, expert) lane
    scale, act_scale = cache["scale"], cache["act_scale"]
    cur_q = quantize_int8(h, scale)                              # [B, d]
    dq = cur_q.to(torch.int32) - cache["prev_q"][idx].to(torch.int32)
    wi_mask = block_zero_mask(dq, 1, block_k)                    # [B, d/bk]
    hi = cache["prev_hi"][idx] + _lane_delta_product(dq, scale, p["wi"], top_e)
    gate_h, up = torch.chunk(hi, 2, dim=-1)
    act = F.silu(gate_h) * up                                    # [B, f]

    # wo site: Δ of the activation codes, same lanes
    act_q = quantize_int8(act, act_scale)
    dq2 = act_q.to(torch.int32) - cache["prev_act_q"][idx].to(torch.int32)
    wo_mask = block_zero_mask(dq2, 1, block_k)
    out = cache["prev_out"][idx] + _lane_delta_product(dq2, act_scale,
                                                       p["wo"], top_e)

    # only the visited (expert, slot) lanes; the pairs are unique
    cache["prev_q"].index_put_(idx, cur_q)
    cache["prev_hi"].index_put_(idx, hi)
    cache["prev_act_q"].index_put_(idx, act_q)
    cache["prev_out"].index_put_(idx, out)

    sticky = (wi_mask.sum(dim=-1) == 0).float().mean()
    stats = ExpertReuseStats(
        sticky_fraction=sticky,
        wi_skip=1.0 - wi_mask.float().mean(),
        wo_skip=1.0 - wo_mask.float().mean(),
    )
    final = (out * gate[:, None]).reshape(b, 1, d).to(x.dtype)
    return final, cache, stats
