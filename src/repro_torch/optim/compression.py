"""Int8 gradient compression with error feedback, as
`repro.optim.compression`.

Each leaf is quantized to int8 at its own max-abs scale after adding the
residual of the last step; the new residual is what the int8 codes lost, so
the stream of decompressed gradients is unbiased over steps (the 1-bit Adam
/ PowerSGD lineage). On one card there is no all-reduce to shrink: the train
step keeps the compression so that its state and its arithmetic are the
reference's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import tree_map


class CompressedLeaf(NamedTuple):
    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32 scalar


def _compress_leaf(g: torch.Tensor) -> CompressedLeaf:
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return CompressedLeaf(q=q, scale=scale)


def _decompress_leaf(c: CompressedLeaf) -> torch.Tensor:
    return c.q.float() * c.scale


@torch.no_grad()
def compress_with_feedback(grads: Any, residual: Any | None) -> tuple[Any, Any]:
    """Returns (a tree of CompressedLeaf, the new residual tree, f32)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
    compressed = tree_map(_compress_leaf, corrected)
    new_residual = tree_map(lambda c, x: x - _decompress_leaf(c),
                            compressed, corrected)
    return compressed, new_residual


def decompress(compressed: Any) -> Any:
    if isinstance(compressed, CompressedLeaf):
        return _decompress_leaf(compressed)
    return {k: decompress(v) for k, v in compressed.items()}
