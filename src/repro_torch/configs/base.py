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

    def param_count(self) -> int:
        """Total parameters, as the reference counts them for MODEL_FLOPS =
        6·N·D (rwkv6's token-shift and decay LoRAs are left out, a projection
        is d·d)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mlp_kind == "swiglu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        if self.ssm_kind == "rwkv6":
            per_layer = 5 * d * d + d * d + per_mlp  # r,k,v,g,w + out
            n += self.n_layers * per_layer
        elif self.ssm_kind == "mamba2":
            di = self.d_inner
            per_ssm = d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) + di * d
            n_ssm_layers = self.n_layers
            n += n_ssm_layers * per_ssm
            if self.hybrid_attn_every:
                # one shared attn+mlp block reused across applications
                n += per_attn + per_mlp
        else:
            per_layer = per_attn + per_mlp
            if self.n_experts:
                per_layer = per_attn + self.n_experts * per_mlp
                per_layer += d * self.n_experts  # router
                if self.shared_expert:
                    per_layer += per_mlp
            n += self.n_layers * per_layer
        return n

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: the routed top_k and the
        shared expert)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_mlp = 3 * d * f if self.mlp_kind == "swiglu" else 2 * d * f
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * per_mlp
        return total - inactive

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
