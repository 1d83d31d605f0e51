"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding-window attention (W=4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    attn_kind="swa",
    window=4096,
    mlp_kind="swiglu",
    n_experts=8,
    top_k=2,
    rope="rope",
    rope_theta=1000000.0,
)
