"""HuBERT X-Large [arXiv:2106.07447; unverified].

Encoder-only 48L d_model=1280 16H (MHA, kv=16) d_ff=5120 vocab=504
(masked-unit prediction head). Audio frontend is a STUB: input_specs()
provides precomputed frame embeddings at d_model width.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    attn_kind="full",
    causal=False,
    mlp_kind="gelu",
    rope="none",
    frontend="audio",
    tie_embeddings=False,
)
