"""Qwen2-VL-7B [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE, dynamic
resolution. Vision frontend is a STUB (precomputed patch embeddings merge
into the token stream); the LM backbone is what the shapes exercise.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    attn_kind="full",
    mlp_kind="swiglu",
    qkv_bias=True,
    rope="mrope",
    rope_theta=1000000.0,
    frontend="vision",
)
