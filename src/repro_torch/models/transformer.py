"""Dense decoder: parameters, decode state, forward, logits.

Parameters are a plain dict laid out as the JAX package's pytree: the block
leaves stay STACKED with a leading [L] axis (`params["blocks"]["attn"]["wqkv"]`
is [L, d, q+2kv]), and layer l reads the contiguous views `leaf[l]`. The
reference's `lax.scan` over stacked blocks becomes a Python loop over layers;
the per-layer lane of the KV cache and of every reuse site is a view, and
both are updated in place.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_norm,
    attention_forward,
    mlp_forward,
)


def _check_dense(cfg: ModelConfig) -> None:
    """This slice ports one model family: dense, full causal attention with
    RoPE, a swiglu MLP, tied embeddings, an unquantized KV cache."""
    if (cfg.family != "dense" or cfg.n_experts or cfg.ssm_kind != "none"
            or cfg.frontend != "none" or cfg.attn_kind != "full"
            or cfg.rope != "rope" or cfg.mlp_kind != "swiglu"
            or not cfg.tie_embeddings or cfg.kv_head_pad_to
            or cfg.kv_cache_quant):
        raise NotImplementedError(
            f"{cfg.name}: only the dense qwen3-style path is ported")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(
    cfg: ModelConfig, seed: int = 0, *, device="cuda"
) -> Params:
    """Random parameters made on `device` from a seeded torch.Generator, at
    the reference's scales: normal/sqrt(fan_in) for weights, 0.01 for the
    embedding, zero norm scales (rms_norm multiplies by 1 + scale)."""
    _check_dense(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, dt = cfg.n_superblocks, cfg.d_model, cfg.dtype

    def dense(*shape):
        t = torch.randn((L, *shape), generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(1.0 / math.sqrt(shape[0])).to(dt)

    def norm(width):
        return {"scale": torch.zeros((L, width), dtype=torch.float32,
                                     device=device)}

    attn = {
        "wqkv": dense(d, cfg.q_dim + 2 * cfg.kv_dim),
        "wo": dense(cfg.q_dim, d),
        "norm": norm(d),
    }
    if cfg.qk_norm:
        attn["q_norm"] = norm(cfg.head_dim)
        attn["k_norm"] = norm(cfg.head_dim)
    embed = torch.randn((cfg.vocab, d), generator=gen, device=device,
                        dtype=torch.float32).mul_(0.01).to(dt)
    params: Params = {
        "embed": embed,
        "blocks": {"attn": attn,
                   "mlp": {"wi": dense(d, 2 * cfg.d_ff), "wo": dense(cfg.d_ff, d),
                           "norm": norm(d)}},
        "final_norm": {"scale": torch.zeros((d,), dtype=torch.float32,
                                            device=device)},
    }
    return params


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> Params:
    """The JAX package's parameter pytree, as numpy arrays, to this
    package's parameters: same nesting, block leaves stay stacked [L, ...].
    Floating leaves go through float32 (exact for bf16, which numpy holds as
    `ml_dtypes.bfloat16` and `torch.from_numpy` rejects) and land in the
    config's dtype for weight matrices, float32 for norm scales."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind in "iub":
            return torch.from_numpy(a.copy()).to(device)
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        dt = torch.float32 if a.dtype == np.float32 else cfg.dtype
        return t.to(device=device, dtype=dt)

    return _tree_map(conv, tree)


def init_decode_state(
    cfg: ModelConfig, batch: int, cache_len: int, *, device="cuda"
) -> dict:
    """KV caches [L, B, S, KV, D] and the valid length (a device scalar)."""
    _check_dense(cfg)
    shape = (cfg.n_superblocks, batch, cache_len, cfg.kv_heads_eff, cfg.head_dim)
    return {
        "len": torch.zeros((), dtype=torch.int32, device=device),
        "blocks": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                   "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
    }


def embed_inputs(params: Params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    return params["embed"][inputs["tokens"].long()]


def output_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
                  *, vocab_chunk: int = 16384) -> torch.Tensor:
    """f32 logits [B, S, V] of the tied head, as the reference's
    preferred_element_type=f32 product: the bf16 embedding is widened to f32
    a vocabulary chunk at a time, so no bf16 rounding of the logits."""
    h = apply_norm(params["final_norm"], h, cfg.norm_eps).float()
    emb = params["embed"]
    out = torch.empty((*h.shape[:-1], emb.shape[0]), dtype=torch.float32,
                      device=h.device)
    for v0 in range(0, emb.shape[0], vocab_chunk):
        out[..., v0:v0 + vocab_chunk] = h @ emb[v0:v0 + vocab_chunk].float().T
    return out


def _layer(tree, layer: int):
    return _tree_map(lambda t: t[layer], tree)


def forward(
    params: Params,
    cfg: ModelConfig,
    inputs: dict,
    *,
    decode_state: dict | None = None,
    reuse_engine=None,
    reuse_cache: dict | None = None,
):
    """Returns (hidden [B,S,d], new_decode_state, reuse_cache, stats). The
    decode state's KV lanes and the reuse cache are updated in place."""
    _check_dense(cfg)
    decode = decode_state is not None
    x = embed_inputs(params, cfg, inputs)
    b, s, _ = x.shape
    ar = torch.arange(s, device=x.device, dtype=torch.int32)
    if decode:
        positions = (decode_state["len"] + ar)[None, :].expand(b, s)
    else:
        positions = ar[None, :].expand(b, s)
    stats: dict[str, Any] = {}
    for layer in range(cfg.n_superblocks):
        bp = _layer(params["blocks"], layer)
        kv = _layer(decode_state["blocks"], layer) if decode else None
        rctx = None
        if reuse_engine is not None and reuse_cache is not None:
            rctx = (reuse_engine, reuse_engine.layer_view(reuse_cache, layer),
                    stats)
        x = x + attention_forward(
            bp["attn"], cfg, x, positions=positions, kv_cache=kv,
            kv_len=decode_state["len"] if decode else None, reuse_ctx=rctx,
        )
        x = x + mlp_forward(bp["mlp"], cfg, x, reuse_ctx=rctx)
    new_state = None
    if decode:
        new_state = {"len": decode_state["len"] + s,
                     "blocks": decode_state["blocks"]}
    return x, new_state, reuse_cache, stats
