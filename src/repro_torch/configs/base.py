"""ModelConfig — the config dataclass (data only; same fields as `repro`).

Frozen so a config hashes and prints reproducibly. `reduced()` returns the
same family at smoke-test scale, exactly as the JAX package cuts it, so a
reduced config means the same shapes in both packages.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention pattern ---
    attn_kind: str = "full"      # full | swa | local_global | none
    window: int = 4096
    local_ratio: int = 0
    causal: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"           # rope | mrope | none
    rope_theta: float = 1_000_000.0

    # --- mlp ---
    mlp_kind: str = "swiglu"     # swiglu | gelu | relu2

    # --- moe ---
    n_experts: int = 0
    top_k: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # --- ssm / hybrid ---
    ssm_kind: str = "none"
    ssm_state: int = 64
    ssm_head_dim: int = 64
    hybrid_attn_every: int = 0

    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    max_seq_len: int = 131072
    frontend: str = "none"
    param_dtype: str = "bfloat16"

    # --- execution knobs (not architecture) ---
    kv_head_pad_to: int = 0
    kv_cache_quant: bool = False
    kv_quant_scale: float = 0.05
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 512
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True

    # ---- derived ----
    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:          # mamba2 expansion
        return 2 * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_kind == "mamba2":
            return self.d_inner // self.ssm_head_dim
        if self.ssm_kind == "rwkv6":
            return self.d_model // self.ssm_head_dim
        return 0

    @property
    def superblock_layers(self) -> int:
        if self.attn_kind == "local_global" and self.local_ratio:
            return self.local_ratio + 1
        if self.hybrid_attn_every:
            return self.hybrid_attn_every
        return 1

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % self.superblock_layers:
            raise ValueError((self.n_layers, self.superblock_layers))
        return self.n_layers // self.superblock_layers

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def kv_heads_eff(self) -> int:
        return max(self.n_kv_heads, self.kv_head_pad_to)

    def reduced(self) -> "ModelConfig":
        """Same family, smoke-test scale. Keeps every structural feature."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2 * self.superblock_layers, self.superblock_layers),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            window=min(self.window, 64),
            max_seq_len=256,
            attn_chunk_q=32,
            attn_chunk_kv=32,
            loss_chunk=32,
            ssm_head_dim=32,
            ssm_state=16,
            param_dtype="float32",
        )
