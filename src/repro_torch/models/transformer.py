"""Model composition: parameters, decode state, forward, logits.

The ported families: the dense decoder (qwen3-style, tied embeddings;
qwen2-72b and nemotron-4-15b with untied heads, a QKV bias or a squared-ReLU
MLP; qwen2-vl-7b with M-RoPE and the vision stub), the local:global decoder
(gemma3: superblocks of 5 sliding-window layers and one global layer), the
MoE decoder (the same attention, full or sliding-window with a rolling KV
cache, and a routed-expert block in place of the MLP; mixtral and
llama4-scout), RWKV6 (time mix + channel mix per block, an untied LM head, a
recurrent state instead of a KV cache) and the zamba2 hybrid (superblocks of
6 Mamba2 blocks, then one attention+MLP block whose weights all superblocks
share, with a KV cache of its own in each). For training only: the hubert
encoder (the audio stub's `embed_proj`, bidirectional attention without
RoPE, a gelu MLP, an untied head), which has no decode path.

Parameters are a plain dict laid out as the JAX package's pytree: the block
leaves stay STACKED with a leading [L] axis (`params["blocks"]["attn"]["wqkv"]`
is [L, d, q+2kv], `params["blocks"]["rwkv"]["tmix"]["wr"]` is [L, d, d];
gemma3's `local` and zamba2's `mamba` leaves [L, n, ...]), and layer l reads
the contiguous views `leaf[l]`. The reference's `lax.scan` over stacked
blocks becomes a Python loop over layers; the per-layer lane of the decode
state (KV caches, rwkv or Mamba2 state) and of every reuse site is a view,
and both are updated in place. Without a decode state (training) nothing is
written in place, so autograd passes through the forward, and with
`cfg.remat` each superblock is rematerialised in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body; `remat_policy="dots"` keeps the matrix products' outputs).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import f32_product
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    apply_norm,
    attention_forward,
    mlp_forward,
)

MLP_KINDS = ("swiglu", "gelu", "relu2")


def check_family(cfg: ModelConfig, *, training: bool = False) -> None:
    """The ported families: dense decoders (full causal attention with RoPE
    or M-RoPE, a swiglu, gelu or squared-ReLU MLP, tied or untied head, an
    optional QKV bias; the vision stub), the local:global decoder, MoE (full
    or sliding-window attention, routed swiglu experts, with or without a
    shared expert), rwkv6 (attention-free, untied LM head) and the Mamba2
    hybrid with a shared attention block; any of them with `kv_head_pad_to`
    (KV heads duplicated into the cache) and `kv_cache_quant` (an int8 KV
    cache). With `training`, also the audio encoder (hubert: the frame
    embedding stub, bidirectional attention without RoPE, an untied head).
    Anything else raises, and the audio frontend without `training` (an
    encoder has no decode path)."""
    audio = (training and cfg.family == "audio" and cfg.frontend == "audio"
             and not cfg.causal and cfg.rope == "none"
             and cfg.attn_kind == "full" and cfg.ssm_kind == "none"
             and not cfg.hybrid_attn_every and not cfg.n_experts
             and cfg.mlp_kind in MLP_KINDS and not cfg.tie_embeddings)
    if audio:
        return
    common = (cfg.frontend not in ("none", "vision") or not cfg.causal
              or (cfg.frontend == "vision") != (cfg.family == "vlm"))
    attn = (cfg.ssm_kind == "none" and not cfg.hybrid_attn_every
            and cfg.rope in ("rope", "mrope"))
    dense = (attn and cfg.family in ("dense", "vlm") and not cfg.n_experts
             and cfg.mlp_kind in MLP_KINDS
             and (cfg.attn_kind == "full"
                  or (cfg.attn_kind == "local_global" and cfg.local_ratio > 0)))
    moe = (attn and cfg.family == "moe" and cfg.n_experts > 0
           and cfg.mlp_kind == "swiglu" and cfg.tie_embeddings
           and cfg.attn_kind in ("full", "swa"))
    rwkv6 = (cfg.family == "ssm" and cfg.ssm_kind == "rwkv6"
             and cfg.attn_kind == "none" and not cfg.tie_embeddings
             and not cfg.n_experts)
    hybrid = (cfg.family == "hybrid" and cfg.ssm_kind == "mamba2"
              and cfg.hybrid_attn_every > 0 and cfg.attn_kind == "full"
              and cfg.rope == "rope" and not cfg.n_experts
              and cfg.mlp_kind in MLP_KINDS)
    if common or not (dense or moe or rwkv6 or hybrid):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoders (qwen3, qwen2, nemotron, "
            "qwen2-vl, gemma3 local:global), the MoE (mixtral, llama4-scout), "
            "the rwkv6 and the zamba2 hybrid paths are ported; not the audio "
            "frontend")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(
    cfg: ModelConfig, seed: int = 0, *, device="cuda"
) -> Params:
    """Random parameters made on `device` from a seeded torch.Generator, at
    the reference's scales: normal/sqrt(fan_in) for weights, 0.01 for the
    embedding, zero norm scales (rms_norm multiplies by 1 + scale). The
    audio encoder has `embed_proj` [d, d] in place of the embedding."""
    check_family(cfg, training=True)
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

    def dense(*shape, lead=(L,)):
        t = torch.randn((*lead, *shape), generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(1.0 / math.sqrt(shape[0])).to(dt)

    def zeros(*shape, lead=(L,)):
        return torch.zeros((*lead, *shape), dtype=torch.float32,
                           device=device)

    def attention(lead=(L,)):
        p = {"wqkv": dense(d, cfg.q_dim + 2 * cfg.kv_dim, lead=lead),
             "wo": dense(cfg.q_dim, d, lead=lead),
             "norm": {"scale": zeros(d, lead=lead)}}
        if cfg.qkv_bias:
            p["bqkv"] = zeros(cfg.q_dim + 2 * cfg.kv_dim, lead=lead)
        if cfg.qk_norm:
            p["q_norm"] = {"scale": zeros(cfg.head_dim, lead=lead)}
            p["k_norm"] = {"scale": zeros(cfg.head_dim, lead=lead)}
        return p

    def mlp(lead=(L,)):
        fi = 2 * cfg.d_ff if cfg.mlp_kind == "swiglu" else cfg.d_ff
        return {"wi": dense(d, fi, lead=lead), "wo": dense(cfg.d_ff, d, lead=lead),
                "norm": {"scale": zeros(d, lead=lead)}}

    def embedding():
        return torch.randn((cfg.vocab, d), generator=gen, device=device,
                           dtype=torch.float32).mul_(0.01).to(dt)

    params: Params = {}
    if cfg.ssm_kind == "mamba2":
        # the hybrid: the shared attention+MLP block lives outside the stack
        params["blocks"] = {"mamba": ssm_mod.init_mamba2(
            cfg, gen, lead=(L, cfg.hybrid_attn_every), device=device)}
        params["shared_block"] = {"attn": attention(()), "mlp": mlp(())}
        params["embed"] = embedding()
    elif cfg.attn_kind == "local_global":
        local = (L, cfg.local_ratio)
        params["blocks"] = {
            "local": {"attn": attention(local), "mlp": mlp(local)},
            "global": {"attn": attention(), "mlp": mlp()}}
        params["embed"] = embedding()
    else:
        attn = attention()
        if cfg.frontend == "audio":
            # the stub frontend: frame embeddings arrive at d_model width
            params["embed_proj"] = dense(d, d, lead=())
        else:
            params["embed"] = embedding()
        params["blocks"] = {"attn": attn, **(
            {"moe": moe_mod.init_moe(cfg, gen, layers=L, device=device)}
            if cfg.n_experts else {"mlp": mlp()})}
    params["final_norm"] = final_norm
    if not cfg.tie_embeddings or cfg.frontend == "audio":
        params["lm_head"] = dense(d, cfg.vocab, lead=())
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


def train_state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The JAX package's train state `{params, opt: {mu, nu, step},
    residual?}`, as numpy arrays, to this package's: the parameters through
    `params_from_numpy`, the moments and the residual as float32, `step` an
    int32 0-d tensor, all on `device`."""
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, dtype=np.float32).copy()).to(device)
    opt = tree["opt"]
    state = {"params": params_from_numpy(tree["params"], cfg, device),
             "opt": {"mu": _tree_map(f32, opt["mu"]),
                     "nu": _tree_map(f32, opt["nu"]),
                     "step": torch.tensor(int(np.asarray(opt["step"])),
                                          dtype=torch.int32, device=device)}}
    if tree.get("residual") is not None:
        state["residual"] = _tree_map(f32, tree["residual"])
    return state


def init_decode_state(
    cfg: ModelConfig, batch: int, cache_len: int, *, device="cuda"
) -> dict:
    """The valid length (a device scalar) and the per-layer state, as the
    reference lays it out: KV caches {k, v} [L, B, S, KV, D], int8 with
    `kv_cache_quant`, else of the model's dtype (dense and MoE;
    S = min(window, cache_len) for sliding-window attention, a rolling
    cache); for gemma3 {local: [L, 5, B, min(window, cache_len), KV, D]
    caches, global: [L, B, S, KV, D]}; for zamba2 {mamba: {conv [L, 6, B,
    3, C], h [L, 6, B, nh, hd, state] f32}, shared_kv: [L, B, S, KV, D]};
    or the rwkv state {tmix: {shift [L, B, d], wkv [L, B, H, dk, dv] f32},
    cmix: {shift}} (rwkv6)."""
    check_family(cfg)
    nsb = cfg.n_superblocks
    length = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.ssm_kind == "rwkv6":
        return {"len": length,
                "blocks": ssm_mod.init_rwkv6_state(
                    cfg, batch, layers=nsb, device=device)}

    kv_dtype = torch.int8 if cfg.kv_cache_quant else cfg.dtype

    def kv(*lead, seq):
        shape = (*lead, batch, seq, cfg.kv_heads_eff, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                "v": torch.zeros(shape, dtype=kv_dtype, device=device)}

    if cfg.ssm_kind == "mamba2":
        blocks = {"mamba": ssm_mod.init_mamba2_state(
                      cfg, batch, lead=(nsb, cfg.hybrid_attn_every),
                      device=device),
                  "shared_kv": kv(nsb, seq=cache_len)}
    elif cfg.attn_kind == "local_global":
        blocks = {"local": kv(nsb, cfg.local_ratio,
                              seq=min(cfg.window, cache_len)),
                  "global": kv(nsb, seq=cache_len)}
    elif cfg.attn_kind == "swa":
        blocks = kv(nsb, seq=min(cfg.window, cache_len))
    else:
        blocks = kv(nsb, seq=cache_len)
    return {"len": length, "blocks": blocks}


def embed_inputs(params: Params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    """Token embeddings; with `vision_embeds` [B, P, d] and
    `vision_positions` [B, P] (the VLM stub), the precomputed patch
    embeddings overwrite their token slots. The audio stub projects its
    frame embeddings `embeds` [B, S, d] by `embed_proj`, one product with an
    f32 result rounded once to the model's dtype."""
    if cfg.frontend == "audio":
        x = inputs["embeds"].to(cfg.dtype)
        b, s, d = x.shape
        out = f32_product(x.reshape(b * s, d), params["embed_proj"])
        return out.reshape(b, s, -1).to(cfg.dtype)
    x = params["embed"][inputs["tokens"].long()]
    ve = inputs.get("vision_embeds")
    if ve is not None:
        vp = inputs["vision_positions"].long()
        x = x.scatter(1, vp[..., None].expand(*vp.shape, x.shape[-1]),
                      ve.to(x.dtype))
    return x


def output_logits(params: Params, cfg: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """f32 logits [B, S, V] of the untied `lm_head` [d, V] where there is
    one, else of the tied embedding [V, d], as the reference's
    preferred_element_type=f32 product: on the card one bf16 product with an
    f32 result (`ops.f32_product`), so the head is never widened and the
    logits are not rounded to bf16; on the CPU both in f32."""
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    head = params.get("lm_head")
    w = head if head is not None else params["embed"].T
    out = f32_product(h.reshape(-1, h.shape[-1]), w)
    return out.reshape(*h.shape[:-1], w.shape[1])


# the matrix products whose outputs `remat_policy="dots"` keeps, as
# jax.checkpoint_policies.dots_saveable does
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.mm.dtype,
                      torch.ops.aten.bmm.dtype})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(policy: str) -> dict:
    """torch.utils.checkpoint's keywords for `remat_policy`: "full" saves
    only the superblock's input, "dots" also every matrix product's
    output."""
    if policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    if policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return {}


def _layer(tree, layer: int):
    return _tree_map(lambda t: t[layer], tree)


def _unstacked(tree):
    """Each stacked leaf as the tuple of its [L] slices (`unbind`), for the
    training forward: `_layer` then picks a slice, and the backward stacks
    the L slice gradients once, where a view `leaf[l]` a layer would add L
    zero-padded full-size gradients."""
    return _tree_map(lambda t: t.unbind(0), tree)


def _rwkv6_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 st: dict | None, rctx) -> torch.Tensor:
    """One rwkv6 block: x + time_mix(norm1 x), then + channel_mix(norm2 x).
    Without a decode state the block starts from a zero state and writes
    nothing in place."""
    h, _ = ssm_mod.rwkv6_time_mix(p, cfg, apply_norm(p["norm1"], x,
                                                     cfg.norm_eps),
                                  st["tmix"] if st is not None else None,
                                  reuse_ctx=rctx)
    x = x + h
    h, _ = ssm_mod.rwkv6_channel_mix(p, cfg, apply_norm(p["norm2"], x,
                                                        cfg.norm_eps),
                                     st["cmix"] if st is not None else None,
                                     reuse_ctx=rctx)
    return x + h


def _hybrid_block(cfg: ModelConfig, bp: Params, shared: Params,
                  x: torch.Tensor, st: dict | None, *, positions, kv_len,
                  rctx) -> torch.Tensor:
    """One zamba2 superblock: 6 Mamba2 blocks without reuse, then the shared
    attention+MLP block under the sites `shared_attn_*` and `shared_mlp_*`,
    with this superblock's own KV cache. Without a decode state the Mamba2
    blocks start from a zero state."""
    mamba = bp["mamba"] if st is not None else _unstacked(bp["mamba"])
    for i in range(cfg.hybrid_attn_every):
        ms = _layer(st["mamba"], i) if st is not None else None
        h, _ = ssm_mod.mamba2_forward(_layer(mamba, i), cfg, x, ms)
        x = x + h
    x = x + attention_forward(
        shared["attn"], cfg, x, positions=positions,
        kv_cache=st["shared_kv"] if st is not None else None, kv_len=kv_len,
        reuse_ctx=rctx, site_prefix="shared_attn")
    return x + mlp_forward(shared["mlp"], cfg, x, reuse_ctx=rctx,
                           site_prefix="shared_mlp")


def _local_global_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                        st: dict | None, *, positions, kv_len,
                        rctx) -> torch.Tensor:
    """One gemma3 superblock: `local_ratio` layers of sliding-window
    attention at `window` and an MLP, without reuse (as in the reference),
    then the global layer under the sites `attn_global_*` and
    `mlp_global_*`."""
    local = bp["local"] if st is not None else _unstacked(bp["local"])
    for i in range(cfg.local_ratio):
        lp = _layer(local, i)
        x = x + attention_forward(
            lp["attn"], cfg, x, layer_window=cfg.window, positions=positions,
            kv_cache=_layer(st["local"], i) if st is not None else None,
            kv_len=kv_len, site_prefix="attn_local")
        x = x + mlp_forward(lp["mlp"], cfg, x)
    gp = bp["global"]
    x = x + attention_forward(
        gp["attn"], cfg, x, positions=positions,
        kv_cache=st["global"] if st is not None else None, kv_len=kv_len,
        reuse_ctx=rctx, site_prefix="attn_global")
    return x + mlp_forward(gp["mlp"], cfg, x, reuse_ctx=rctx,
                           site_prefix="mlp_global")


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
    decode state's lanes and the reuse cache are updated in place. Without a
    decode state (training; the audio encoder only so) nothing is written
    in place, and with `cfg.remat` and autograd on, each superblock is
    rematerialised in the backward."""
    decode = decode_state is not None
    check_family(cfg, training=not decode)
    x = embed_inputs(params, cfg, inputs)
    b, s, _ = x.shape
    ar = torch.arange(s, device=x.device, dtype=torch.int32)
    if decode:
        positions = (decode_state["len"] + ar)[None, :].expand(b, s)
    else:
        positions = ar[None, :].expand(b, s)
    if cfg.rope == "mrope":
        positions = positions[None].expand(3, b, s)
    kv_len = decode_state["len"] if decode else None
    stats: dict[str, Any] = {}
    window = cfg.window if cfg.attn_kind == "swa" else None
    blocks = params["blocks"] if decode else _unstacked(params["blocks"])

    def block(x, layer):
        bp = _layer(blocks, layer)
        st = _layer(decode_state["blocks"], layer) if decode else None
        rctx = None
        if reuse_engine is not None and reuse_cache is not None:
            rctx = (reuse_engine, reuse_engine.layer_view(reuse_cache, layer),
                    stats)
        if cfg.ssm_kind == "rwkv6":
            return _rwkv6_block(bp["rwkv"], cfg, x, st, rctx)
        if cfg.ssm_kind == "mamba2":
            return _hybrid_block(cfg, bp, params["shared_block"], x, st,
                                 positions=positions, kv_len=kv_len,
                                 rctx=rctx)
        if cfg.attn_kind == "local_global":
            return _local_global_block(cfg, bp, x, st, positions=positions,
                                       kv_len=kv_len, rctx=rctx)
        x = x + attention_forward(
            bp["attn"], cfg, x, layer_window=window, positions=positions,
            kv_cache=st, kv_len=kv_len, reuse_ctx=rctx)
        if cfg.n_experts:
            return x + moe_mod.moe_forward(bp["moe"], cfg, x, reuse_ctx=rctx)
        return x + mlp_forward(bp["mlp"], cfg, x, reuse_ctx=rctx)

    remat = cfg.remat and not decode and torch.is_grad_enabled()
    for layer in range(cfg.n_superblocks):
        if remat:
            x = checkpoint(block, x, layer, use_reentrant=False,
                           **_remat_kwargs(cfg.remat_policy))
        else:
            x = block(x, layer)
    new_state = None
    if decode:
        new_state = {"len": decode_state["len"] + s,
                     "blocks": decode_state["blocks"]}
    return x, new_state, reuse_cache, stats
