"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf].

Dense 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk-norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    attn_kind="full",
    mlp_kind="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=1000000.0,
)
