"""AdamW with decoupled weight decay, as `repro.optim.adamw`.

Mixed-precision discipline: the moments are f32 whatever the (possibly bf16)
parameter dtype; the update is computed in f32 and cast back. The state is a
plain tree that mirrors the parameters, so it checkpoints with them in the
reference's layout: {"mu", "nu", "step"}, `step` a 0-d int32 tensor.

The update runs leaf by leaf and writes the parameters and moments IN PLACE,
so a step holds one leaf's f32 transients at a time (one stacked `mlp.wi`
leaf of qwen3-32b is 1.05 GB a layer in f32): the clipped f32 gradient of a
leaf is made inside the loop, from the global norm taken first. Leaves are
visited in the reference's order (dict keys sorted), and the arithmetic is
the reference's, op for op, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in the reference's order (keys sorted, as
    `jax.tree.leaves` flattens a dict); None is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    leaves = tree_leaves(params)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """(every leaf as f32 times min(1, max_norm / norm), the norm). The
    update does not call this: it clips each leaf inside its loop."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: dict,
    lr_scale: torch.Tensor | float = 1.0,
) -> tuple[Any, dict, dict]:
    """One step. Returns (params, state, metrics {"grad_norm", "lr"}); the
    parameters, the moments and the step are updated in place, and the
    returned trees are the ones passed in. Weight decay applies to the
    leaves of ndim >= 2, as in the reference (on the stacked layout a norm
    scale [L, d] takes it too)."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    lr = cfg.lr * lr_scale
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        # each in-place op rounds where the reference's expression does:
        # mu = b1·mu + (1 - b1)·g, nu = b2·nu + ((1 - b2)·g)·g,
        # delta = (mu / b1c) / (sqrt(nu / b2c) + eps) [+ wd·p], p - lr·delta
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = torch.div(mu, b1c).div_(
            torch.div(nu, b2c).sqrt_().add_(cfg.eps))
        pf = p.float()
        if p.ndim >= 2:
            delta.add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(lr * delta))
        del delta, pf
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
