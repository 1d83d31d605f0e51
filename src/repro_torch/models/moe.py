"""Mixture-of-Experts: top-k routing with capacity-bounded sorted dispatch,
as the JAX package's `models.moe`.

Tokens are ranked within their expert and placed into an [E, C+1, d]
buffer (the last row takes the dropped ones), so the expert GEMMs carry the
active FLOPs only. The routed experts see a different token stream every
step (routing flips), so they are not reuse sites; a shared expert, where
the config has one, is (`moe_shared_in`, `moe_shared_out`).

On the card the expert GEMMs are bf16 products with an f32 result
(`ops.f32_product`): a layer's experts are GBs of bf16 weights (2.82 GB on
mixtral-8x7b), which are never widened. Every write is deterministic, so a
CUDA graph replays a step bitwise: the kept (expert, slot) pairs of the
dispatch are unique and the dropped rows all write zeros into the drop row;
the combine adds a token's k expert outputs in order, k = 0, 1, … (the
reference's scatter-add, `(0 + y0) + y1`), with no atomics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, _maybe_reuse_matmul, apply_norm


def init_moe(cfg: ModelConfig, gen: torch.Generator, *, layers: int,
             device) -> Params:
    """Random parameters of `layers` stacked MoE blocks ([L, ...] leaves) on
    `device` at the reference's scales: an f32 router of normal/sqrt(d),
    expert weights wi [E, d, 2f] of normal/sqrt(d) and wo [E, f, d] of
    normal/sqrt(f) in the config's dtype, a zero norm scale, and the shared
    expert (normal/sqrt(fan_in)) where the config has one. Each [d, ·]
    matrix is drawn in f32 on its own, so the f32 draws never hold more
    than one matrix."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.dtype

    def normal(*shape, scale, dtype=dt):
        """[layers, *shape]: each trailing 2-D matrix drawn in f32, scaled,
        and stored in `dtype`."""
        out = torch.empty((layers, *shape), dtype=dtype, device=device)
        flat = out.view(-1, *shape[-2:])
        for i in range(flat.shape[0]):
            t = torch.randn(shape[-2:], generator=gen, device=device,
                            dtype=torch.float32)
            flat[i].copy_(t.mul_(scale))
        return out

    p: Params = {
        "router": normal(d, e, scale=1.0 / math.sqrt(d), dtype=torch.float32),
        "wi": normal(e, d, 2 * f, scale=1.0 / math.sqrt(d)),
        "wo": normal(e, f, d, scale=1.0 / math.sqrt(f)),
        "norm": {"scale": torch.zeros((layers, d), dtype=torch.float32,
                                      device=device)},
    }
    if cfg.shared_expert:
        p["shared_wi"] = normal(d, 2 * f, scale=1.0 / math.sqrt(d))
        p["shared_wo"] = normal(f, d, scale=1.0 / math.sqrt(f))
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: at least 8, rounded up to 8 (static per token
    count, so each prefill shape and the decode step keep one graph)."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(p: Params, cfg: ModelConfig, h: torch.Tensor):
    """Top-k routing of h [T, d]: (expert ids [T, k], renormalized gates
    [T, k] f32), from the f32 router logits' softmax."""
    logits = h.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.top_k, dim=-1)
    top_g = top_g / torch.clamp(top_g.sum(dim=-1, keepdim=True), min=1e-9)
    return top_e, top_g


def dispatch(top_e: torch.Tensor, top_g: torch.Tensor, n_experts: int,
             cap: int):
    """Each (token, choice) pair's expert slot: its rank among the pairs
    routed to that expert (GShard's position_in_expert), kept below `cap`.
    Returns (expert [T*k], gate [T*k] f32 with the dropped pairs' zeroed,
    slot [T*k] int64 with the dropped pairs' at `cap`, keep [T*k] bool)."""
    flat_e = top_e.reshape(-1)
    experts = torch.arange(n_experts, device=top_e.device)
    onehot = (flat_e[:, None] == experts[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1     # [T*k, E]
    pos_in_e = pos.gather(1, flat_e[:, None]).squeeze(1)
    keep = pos_in_e < cap
    flat_g = top_g.reshape(-1)
    flat_g = torch.where(keep, flat_g, torch.zeros_like(flat_g))
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    return flat_e, flat_g, slot.long(), keep


def moe_forward(
    p: Params, cfg: ModelConfig, x: torch.Tensor, *, reuse_ctx=None,
    site_prefix: str = "moe",
) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    h = apply_norm(p["norm"], x, cfg.norm_eps).reshape(t, d)
    top_e, top_g = route(p, cfg, h)

    cap = _capacity(cfg, t)
    flat_e, flat_g, slot, keep = dispatch(top_e, top_g, e, cap)

    # the expert buffer [E, C+1, d]; a dropped token writes zeros into the
    # drop row, whose output its zero gate discards
    rows = h.repeat_interleave(k, dim=0)                         # h[tok_idx]
    rows = torch.where(keep[:, None], rows, torch.zeros_like(rows))
    xe = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    xe.index_put_((flat_e, slot), rows)

    # expert GEMMs (swiglu), active FLOPs only
    hi = ops.f32_product(xe, p["wi"])                            # [E, C+1, 2f]
    gate, up = torch.chunk(hi, 2, dim=-1)
    act = (F.silu(gate) * up).to(x.dtype)
    ye = ops.f32_product(act, p["wo"])                           # [E, C+1, d]

    # gather back with the combine weights, each token's k outputs in order
    yt = (ye[flat_e, slot] * flat_g[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + yt[:, j]

    if cfg.shared_expert:
        hi_s = _maybe_reuse_matmul(f"{site_prefix}_shared_in", h,
                                   p["shared_wi"], None, reuse_ctx)
        g_s, u_s = torch.chunk(hi_s, 2, dim=-1)
        act_s = F.silu(g_s.float()).to(x.dtype) * u_s
        out = out + _maybe_reuse_matmul(f"{site_prefix}_shared_out", act_s,
                                        p["shared_wo"], None,
                                        reuse_ctx).float()
    return out.reshape(b, s, d).to(x.dtype)


def router_aux_loss(p: Params, cfg: ModelConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss of one MoE block on x [B, S, d]:
    E · Σ_e (share of tokens whose top-1 expert is e) · (mean gate of e),
    f32. The gradient reaches the router through the mean gates only (the
    top-1 shares are counts). The reference's train step does not add it to
    the loss, and neither does `train.loss_fn`."""
    d = x.shape[-1]
    h = apply_norm(p["norm"], x, cfg.norm_eps).reshape(-1, d)
    gates = torch.softmax(h.float() @ p["router"], dim=-1)
    top_e = torch.argmax(gates, dim=-1)
    density = F.one_hot(top_e, cfg.n_experts).float().mean(dim=0)
    return cfg.n_experts * torch.sum(density * gates.mean(dim=0))
