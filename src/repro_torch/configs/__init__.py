"""Architecture registry of the port: the dense decode slice (qwen3-32b),
the RWKV6 slice (rwkv6-7b) and the MoE family (mixtral-8x7b,
llama4-scout-17b-a16e)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [LLAMA4_SCOUT, MIXTRAL_8X7B, QWEN3_32B, RWKV6_7B]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
