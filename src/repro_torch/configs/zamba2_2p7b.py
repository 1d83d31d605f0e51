"""Zamba2-2.7B [arXiv:2411.15242; hf].

Hybrid: 54 Mamba2 blocks (d_model=2560, ssm_state=64) with a SHARED
attention+MLP block applied every 6 Mamba blocks (9 applications, one set of
weights). Attn 32H kv=32 (MHA, head_dim=80), d_ff=10240, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    attn_kind="full",
    mlp_kind="gelu",
    rope="rope",
    rope_theta=10000.0,
    ssm_kind="mamba2",
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,
)
