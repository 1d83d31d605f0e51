"""Input specs for every (arch × shape) cell, as `repro.launch.specs`.

A spec is a tensor on the "meta" device (shape and dtype, no storage), where
the reference has a `jax.ShapeDtypeStruct`. `make_dummy_inputs` makes the
same structure with real tensors for smoke tests at reduced scale.

Assigned shape set (LM family, seq_len × global_batch):
    train_4k      4096 × 256     train_step
    prefill_32k   32768 × 32     serve prefill
    decode_32k    1 new token, KV cache 32768, batch 128    serve decode
    long_500k     1 new token, KV cache 524288, batch 1     serve decode
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# Archs whose attention is quadratic everywhere: long_500k is skipped.
# Encoder-only archs have no decode at all.
FULL_ATTN_ARCHS = {
    "llama4-scout-17b-a16e", "nemotron-4-15b", "qwen3-32b", "qwen2-72b",
    "qwen2-vl-7b",
}
ENCODER_ARCHS = {"hubert-xlarge"}


def cell_runnable(arch: str, shape: str) -> tuple[bool, str]:
    if shape in ("decode_32k", "long_500k") and arch in ENCODER_ARCHS:
        return False, "encoder-only: no autoregressive decode step exists"
    if shape == "long_500k" and arch in FULL_ATTN_ARCHS:
        return False, "pure full attention: 500k decode KV excluded by assignment"
    return True, ""


def train_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    if cfg.frontend == "audio":
        return {"embeds": _spec((b, s, cfg.d_model), torch.bfloat16),
                "labels": _spec((b, s), torch.int32)}
    return {"tokens": _spec((b, s), torch.int32),
            "labels": _spec((b, s), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    if cfg.frontend == "audio":
        return {"embeds": _spec((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": _spec((b, s), torch.int32)}


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    return {"tokens": _spec((cell.global_batch, 1), torch.int32)}


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_input_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_input_specs(cfg, cell)
    return decode_input_specs(cfg, cell)


def state_specs_struct(tree: Any) -> Any:
    """A tree of tensors as meta tensors of the same shapes and dtypes (no
    allocation)."""
    if isinstance(tree, dict):
        return {k: state_specs_struct(v) for k, v in tree.items()}
    return _spec(tuple(tree.shape), tree.dtype)


def make_dummy_inputs(cfg: ModelConfig, cell: ShapeCell,
                      generator: torch.Generator | None = None, *,
                      device="cuda") -> dict:
    """The cell's inputs as tensors on `device`: integer leaves all 3, float
    leaves standard normal from `generator` (a fresh one seeded 0 when
    None), drawn in f32 and cast to the spec's dtype."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def mk(s: torch.Tensor) -> torch.Tensor:
        if not s.dtype.is_floating_point:
            return torch.full(s.shape, 3, dtype=s.dtype, device=device)
        return torch.randn(s.shape, generator=generator, device=device,
                           dtype=torch.float32).to(s.dtype)

    return {k: mk(s) for k, s in input_specs(cfg, cell).items()}
