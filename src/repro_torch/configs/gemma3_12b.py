"""Gemma-3-12B [hf:google/gemma-3-1b-pt family; unverified].

Dense 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; 5:1
local:global attention (local window 1024), 128k context, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    attn_kind="local_global",
    local_ratio=5,
    window=1024,
    mlp_kind="gelu",
    qk_norm=True,
    rope="rope",
    rope_theta=1000000.0,
    max_seq_len=131072,
)
