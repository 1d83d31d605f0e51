"""Architecture registry of the port: every config of the JAX package.

The decoders serve (dense qwen3, qwen2-72b and nemotron-4-15b; qwen2-vl-7b
with M-RoPE and the vision stub; gemma3-12b local:global; the MoE family;
rwkv6; the zamba2 hybrid); hubert-xlarge, an encoder, is registered so its
serve refuses it as the reference's does.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT_XLARGE
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from repro_torch.configs.qwen2_72b import CONFIG as QWEN2_72B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B
from repro_torch.configs.zamba2_2p7b import CONFIG as ZAMBA2_2P7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        LLAMA4_SCOUT, MIXTRAL_8X7B, NEMOTRON_4_15B, GEMMA3_12B, QWEN3_32B,
        QWEN2_72B, RWKV6_7B, HUBERT_XLARGE, QWEN2_VL_7B, ZAMBA2_2P7B]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
