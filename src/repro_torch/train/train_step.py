"""Training step: chunked-vocab cross-entropy, gradient accumulation, AdamW,
as `repro.train.train_step`.

The loss walks the sequence in chunks so the [B, chunk, V] f32 logits, not
[B, S, V], are the peak intermediate (vocab reaches 262k on gemma3). Each
chunk runs under `torch.utils.checkpoint`, so the backward recomputes its
logits instead of storing them: at qwen3 width, batch 8 and a 128-token
chunk, 0.62 GB.

Gradients come from `torch.autograd` through the model's training forward
(no decode state: nothing is written in place; rwkv6's recurrence is
`kernels.wkv6_decode.WKV6Sequence`, whose backward is a kernel).
Microbatching sums each microbatch's f32 gradient divided by `microbatch`,
in order. The step updates the state's tensors IN PLACE (`adamw_update`)
and returns the same state dict: a caller that needs the state before a step
keeps a copy.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import f32_product
from repro_torch.models import transformer
from repro_torch.models.layers import apply_norm
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.compression import compress_with_feedback, decompress
from repro_torch.optim.schedules import linear_warmup_cosine


def _head_weight(params):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def _chunk_nll(hx: torch.Tensor, w: torch.Tensor,
               lx: torch.Tensor) -> torch.Tensor:
    """Summed token NLL of one chunk: hx [B, c, d], w [d, V], labels lx
    [B, c] (< 0: masked)."""
    b, c, d = hx.shape
    logits = f32_product(hx.reshape(b * c, d), w).reshape(b, c, -1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lx.clamp(min=0).long()[..., None])[..., 0]
    valid = (lx >= 0).float()
    return torch.sum((logz - gold) * valid)


def chunked_xent_loss(
    params: Any, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Mean token cross-entropy with [B, chunk, V] peak logits."""
    b, s, d = h.shape
    chunk = min(cfg.loss_chunk, s)
    while s % chunk:
        chunk -= 1
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    w = _head_weight(params)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(s // chunk):
        args = (h[:, c * chunk:(c + 1) * chunk], w,
                labels[:, c * chunk:(c + 1) * chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    n_valid = torch.clamp((labels >= 0).float().sum(), min=1.0)
    return total / n_valid


def loss_fn(params: Any, cfg: ModelConfig,
            batch: dict) -> tuple[torch.Tensor, dict]:
    h, _, _, _ = transformer.forward(params, cfg, batch)
    loss = chunked_xent_loss(params, cfg, h, batch["labels"])
    return loss, {"loss": loss}


def _with_leaves(tree: Any, leaves) -> Any:
    """`tree` with its leaves replaced, in `tree_leaves` order."""
    it = iter(leaves)

    def put(node):
        if isinstance(node, dict):
            return {k: put(node[k]) for k in sorted(node)}
        return next(it)

    return put(tree)


def make_train_step(
    cfg: ModelConfig,
    opt: AdamWConfig,
    *,
    total_steps: int = 100_000,
    warmup_steps: int = 1_000,
    microbatch: int = 0,           # 0 = no accumulation
    compress_grads: bool = False,  # int8 with error feedback
):
    """Builds train_step(state, batch) -> (state, metrics), state =
    {"params", "opt", "residual"?}, updated in place. The schedule reads
    the step after this one (`opt.step + 1`), as the reference."""

    def compute_grads(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(_with_leaves(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (_with_leaves(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        if microbatch and microbatch > 1:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(microbatch):
                mb_batch = {k: v[i * (v.shape[0] // microbatch):
                                 (i + 1) * (v.shape[0] // microbatch)]
                            for k, v in batch.items()}
                g, m = compute_grads(params, mb_batch)
                for a, gg in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(gg.float() / microbatch)
                del g
                ms.append(m)
            grads = acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            grads, metrics = compute_grads(params, batch)

        residual = state.get("residual")
        if compress_grads:
            compressed, residual = compress_with_feedback(grads, residual)
            grads = decompress(compressed)

        lr_scale = linear_warmup_cosine(
            state["opt"]["step"] + 1, warmup=warmup_steps, total=total_steps)
        new_params, new_opt, opt_metrics = adamw_update(
            opt, params, grads, state["opt"], lr_scale)
        metrics = dict(metrics, **opt_metrics)
        new_state = {"params": new_params, "opt": new_opt}
        if compress_grads:
            new_state["residual"] = residual
        state.clear()
        state.update(new_state)
        return state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     compress_grads: bool = False, device="cuda") -> dict:
    """Parameters from `transformer.init_params(cfg, seed)` on `device`, a
    zero optimizer state, and with `compress_grads` a zero f32 residual."""
    params = transformer.init_params(cfg, seed, device=device)
    state = {"params": params, "opt": init_opt_state(params)}
    if compress_grads:
        state["residual"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state
