"""Architecture registry of the port: the dense decode slice (qwen3-32b) and
the RWKV6 slice (rwkv6-7b)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [QWEN3_32B, RWKV6_7B]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
