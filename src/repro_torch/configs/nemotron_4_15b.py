"""Nemotron-4-15B [arXiv:2402.16819; unverified].

Dense 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU
MLP (no gating), untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    attn_kind="full",
    mlp_kind="relu2",
    tie_embeddings=False,
    rope="rope",
    rope_theta=10000.0,
)
