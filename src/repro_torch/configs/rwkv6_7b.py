"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf].

32L d_model=4096, attention-free (WKV6 with data-dependent decay),
channel-mix d_ff=14336 (3.5x), vocab=65536, head_size 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab=65536,
    attn_kind="none",
    rope="none",
    ssm_kind="rwkv6",
    ssm_head_dim=64,
    tie_embeddings=False,
)
