"""Serving steps: prefill (S > 1 into the caches) and decode (S = 1).

`decode_step` is where ReuseSense lives: the reuse cache threads through the
step beside the KV cache, and every linear site of every layer runs the
fused delta pass and the block-skip ΔW GEMM.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy
from repro_torch.models import forward, init_decode_state, output_logits
from repro_torch.models.transformer import check_family
from repro_torch.obs import trace


def build_reuse_engine(
    cfg: ModelConfig,
    *,
    impl: str = "cuda",
    block_m: int = 8,
    block_k: int = 256,
    policy: ReusePolicy | None = None,
) -> ReuseEngine:
    """Register the decode-time reuse sites, stacked over superblocks, with
    the reference's names and shapes: for a dense transformer the attention
    projections and the MLP (four per layer); for MoE the attention
    projections and, where there is one, the shared expert's two linears;
    for rwkv6 the time mix's r/k/v/g/o projections and the channel mix's
    k/v/r (eight per layer); for the zamba2 hybrid the shared block's
    attention and MLP (`shared_attn_*`, `shared_mlp_*`; the Mamba2 blocks
    carry none); for gemma3 the global layer's (`attn_global_*`,
    `mlp_global_*`; the local layers carry none). The MLP's input site is
    2·d_ff wide for swiglu [gate | up], d_ff for gelu and relu2.
    A tuned `policy` resolves each site's block_k, exec_path and budget."""
    check_family(cfg)
    eng = ReuseEngine(impl=impl, policy=policy or ReusePolicy())
    nsb, d = cfg.n_superblocks, cfg.d_model
    fi = 2 * cfg.d_ff if cfg.mlp_kind == "swiglu" else cfg.d_ff

    def reg(name, fi, fo):
        eng.register(name, fi, fo, n_layers=nsb, block_m=block_m,
                     block_k=block_k)

    def attn_mlp(attn, mlp):
        reg(f"{attn}_qkv", d, cfg.q_dim + 2 * cfg.kv_dim)
        reg(f"{attn}_out", cfg.q_dim, d)
        reg(f"{mlp}_in", d, fi)
        reg(f"{mlp}_out", cfg.d_ff, d)

    if cfg.ssm_kind == "rwkv6":
        for nm in ("wr", "wk", "wv", "wg", "wo"):
            reg(f"rwkv_{nm}", d, d)
        reg("rwkv_cmix_wk", d, cfg.d_ff)
        reg("rwkv_cmix_wv", cfg.d_ff, d)
        reg("rwkv_cmix_wr", d, d)
    elif cfg.ssm_kind == "mamba2":
        attn_mlp("shared_attn", "shared_mlp")
    elif cfg.attn_kind == "local_global":
        attn_mlp("attn_global", "mlp_global")
    elif cfg.n_experts:
        reg("attn_qkv", d, cfg.q_dim + 2 * cfg.kv_dim)
        reg("attn_out", cfg.q_dim, d)
        # routed experts are not reuse sites (their token stream changes
        # with the routing); a shared expert is
        if cfg.shared_expert:
            reg("moe_shared_in", d, 2 * cfg.d_ff)
            reg("moe_shared_out", cfg.d_ff, d)
    else:
        attn_mlp("attn", "mlp")
    return eng


def prefill_step(
    params: Any, cfg: ModelConfig, tokens: torch.Tensor, state: dict
) -> tuple[torch.Tensor, dict]:
    """Process a prompt into the caches. Returns (last-token logits, state)."""
    h, new_state, _, _ = forward(params, cfg, {"tokens": tokens},
                                 decode_state=state)
    return output_logits(params, cfg, h[:, -1:]), new_state


def decode_step(
    params: Any,
    cfg: ModelConfig,
    token: torch.Tensor,     # [B, 1] int
    state: dict,
    *,
    engine: ReuseEngine | None = None,
    reuse_cache: dict | None = None,
) -> tuple[torch.Tensor, dict, dict | None]:
    """One autoregressive step. Returns (logits [B,1,V], state, reuse_cache)."""
    h, new_state, new_rcache, _ = forward(
        params, cfg, {"tokens": token}, decode_state=state,
        reuse_engine=engine, reuse_cache=reuse_cache,
    )
    trace.mark("head", None)  # a marked capture's timing events, else none
    logits = output_logits(params, cfg, h)
    trace.mark("head", "head")
    return logits, new_state, new_rcache


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_to_host(logits: torch.Tensor) -> np.ndarray:
    """The greedy tokens of `logits` as a host array: the copy back waits
    for the step that made them. One `serve.greedy_to_host` span under
    tracing."""
    with trace.span("serve.greedy_to_host"):
        return greedy_sample(logits).cpu().numpy()


def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int,
                     *, device="cuda") -> dict:
    return init_decode_state(cfg, batch, cache_len, device=device)
