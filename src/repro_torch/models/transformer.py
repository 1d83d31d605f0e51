"""Model composition: parameters, decode state, forward, logits.

Three families are ported: the dense decoder (qwen3-style, tied embeddings,
KV cache), the MoE decoder (the same attention, full or sliding-window with
a rolling KV cache, and a routed-expert block in place of the MLP; mixtral
and llama4-scout) and RWKV6 (time mix + channel mix per block, an untied LM
head, a recurrent state instead of a KV cache).

Parameters are a plain dict laid out as the JAX package's pytree: the block
leaves stay STACKED with a leading [L] axis (`params["blocks"]["attn"]["wqkv"]`
is [L, d, q+2kv], `params["blocks"]["rwkv"]["tmix"]["wr"]` is [L, d, d]), and
layer l reads the contiguous views `leaf[l]`. The reference's `lax.scan` over
stacked blocks becomes a Python loop over layers; the per-layer lane of the
decode state (KV cache or rwkv state) and of every reuse site is a view, and
both are updated in place.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    apply_norm,
    attention_forward,
    mlp_forward,
)


def check_family(cfg: ModelConfig) -> None:
    """The ported families: dense (full causal attention with RoPE, a swiglu
    MLP, tied embeddings, an unquantized KV cache), MoE (the same attention,
    full or sliding-window, and routed swiglu experts, with or without a
    shared expert) and rwkv6 (attention-free, untied LM head). Anything
    else raises."""
    common = (cfg.frontend != "none" or cfg.hybrid_attn_every
              or cfg.kv_head_pad_to or cfg.kv_cache_quant)
    decoder = (cfg.ssm_kind == "none" and cfg.rope == "rope"
               and cfg.mlp_kind == "swiglu" and cfg.tie_embeddings)
    dense = (decoder and cfg.family == "dense" and not cfg.n_experts
             and cfg.attn_kind == "full")
    moe = (decoder and cfg.family == "moe" and cfg.n_experts > 0
           and cfg.attn_kind in ("full", "swa"))
    rwkv6 = (cfg.family == "ssm" and cfg.ssm_kind == "rwkv6"
             and cfg.attn_kind == "none" and not cfg.tie_embeddings
             and not cfg.n_experts)
    if common or not (dense or moe or rwkv6):
        raise NotImplementedError(
            f"{cfg.name}: only the dense qwen3-style, the MoE (mixtral, "
            "llama4-scout) and the rwkv6 paths are ported")


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
    check_family(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, dt = cfg.n_superblocks, cfg.d_model, cfg.dtype
    final_norm = {"scale": torch.zeros((d,), dtype=torch.float32,
                                       device=device)}
    if cfg.ssm_kind == "rwkv6":
        blocks = {"rwkv": ssm_mod.init_rwkv6(cfg, gen, layers=L,
                                             device=device)}
        embed = torch.randn((cfg.vocab, d), generator=gen, device=device,
                            dtype=torch.float32).mul_(0.01).to(dt)
        head = torch.randn((d, cfg.vocab), generator=gen, device=device,
                           dtype=torch.float32).mul_(1.0 / math.sqrt(d))
        return {"embed": embed, "blocks": blocks, "final_norm": final_norm,
                "lm_head": head.to(dt)}

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
    if cfg.n_experts:
        blocks = {"attn": attn,
                  "moe": moe_mod.init_moe(cfg, gen, layers=L, device=device)}
    else:
        blocks = {"attn": attn,
                  "mlp": {"wi": dense(d, 2 * cfg.d_ff),
                          "wo": dense(cfg.d_ff, d), "norm": norm(d)}}
    return {"embed": embed, "blocks": blocks, "final_norm": final_norm}


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
    """The valid length (a device scalar) and the per-layer state: KV
    caches [L, B, S, KV, D] (dense and MoE; S = min(window, cache_len) for
    sliding-window attention, a rolling cache), or the rwkv state {tmix:
    {shift [L, B, d], wkv [L, B, H, dk, dv] f32}, cmix: {shift}} (rwkv6)."""
    check_family(cfg)
    length = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.ssm_kind == "rwkv6":
        return {"len": length,
                "blocks": ssm_mod.init_rwkv6_state(
                    cfg, batch, layers=cfg.n_superblocks, device=device)}
    if cfg.attn_kind == "swa":
        cache_len = min(cfg.window, cache_len)
    shape = (cfg.n_superblocks, batch, cache_len, cfg.kv_heads_eff, cfg.head_dim)
    return {
        "len": length,
        "blocks": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                   "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
    }


def embed_inputs(params: Params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    return params["embed"][inputs["tokens"].long()]


def output_logits(params: Params, cfg: ModelConfig, h: torch.Tensor,
                  *, vocab_chunk: int = 16384) -> torch.Tensor:
    """f32 logits [B, S, V] of the untied `lm_head` [d, V] where there is
    one, else of the tied embedding, as the reference's
    preferred_element_type=f32 product: the bf16 weights are widened to f32
    a vocabulary chunk at a time, so no bf16 rounding of the logits."""
    h = apply_norm(params["final_norm"], h, cfg.norm_eps).float()
    head = params.get("lm_head")
    vocab = head.shape[1] if head is not None else params["embed"].shape[0]
    out = torch.empty((*h.shape[:-1], vocab), dtype=torch.float32,
                      device=h.device)
    for v0 in range(0, vocab, vocab_chunk):
        if head is not None:
            wt = head[:, v0:v0 + vocab_chunk].float()
        else:
            wt = params["embed"][v0:v0 + vocab_chunk].float().T
        out[..., v0:v0 + vocab_chunk] = h @ wt
    return out


def _layer(tree, layer: int):
    return _tree_map(lambda t: t[layer], tree)


def _rwkv6_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 st: dict | None, rctx) -> torch.Tensor:
    """One rwkv6 block: x + time_mix(norm1 x), then + channel_mix(norm2 x).
    Without a decode state the block starts from a zero state."""
    if st is None:
        st = ssm_mod.init_rwkv6_state(cfg, x.shape[0], device=x.device)
    h, _ = ssm_mod.rwkv6_time_mix(p, cfg, apply_norm(p["norm1"], x,
                                                     cfg.norm_eps),
                                  st["tmix"], reuse_ctx=rctx)
    x = x + h
    h, _ = ssm_mod.rwkv6_channel_mix(p, cfg, apply_norm(p["norm2"], x,
                                                        cfg.norm_eps),
                                     st["cmix"], reuse_ctx=rctx)
    return x + h


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
    decode state's lanes and the reuse cache are updated in place."""
    check_family(cfg)
    decode = decode_state is not None
    x = embed_inputs(params, cfg, inputs)
    b, s, _ = x.shape
    ar = torch.arange(s, device=x.device, dtype=torch.int32)
    if decode:
        positions = (decode_state["len"] + ar)[None, :].expand(b, s)
    else:
        positions = ar[None, :].expand(b, s)
    stats: dict[str, Any] = {}
    window = cfg.window if cfg.attn_kind == "swa" else None
    for layer in range(cfg.n_superblocks):
        bp = _layer(params["blocks"], layer)
        kv = _layer(decode_state["blocks"], layer) if decode else None
        rctx = None
        if reuse_engine is not None and reuse_cache is not None:
            rctx = (reuse_engine, reuse_engine.layer_view(reuse_cache, layer),
                    stats)
        if cfg.ssm_kind == "rwkv6":
            x = _rwkv6_block(bp["rwkv"], cfg, x, kv, rctx)
            continue
        x = x + attention_forward(
            bp["attn"], cfg, x, layer_window=window, positions=positions,
            kv_cache=kv, kv_len=decode_state["len"] if decode else None,
            reuse_ctx=rctx,
        )
        if cfg.n_experts:
            x = x + moe_mod.moe_forward(bp["moe"], cfg, x, reuse_ctx=rctx)
        else:
            x = x + mlp_forward(bp["mlp"], cfg, x, reuse_ctx=rctx)
    new_state = None
    if decode:
        new_state = {"len": decode_state["len"] + s,
                     "blocks": decode_state["blocks"]}
    return x, new_state, reuse_cache, stats
