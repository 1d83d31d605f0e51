"""Layers of the decoder: norms, RoPE and M-RoPE, attention (full or
sliding-window), MLP (swiglu, gelu or squared ReLU), and their parameter
initialisers (`init_norm`, `init_attention`, `init_mlp`).

Plain PyTorch on explicit parameter dicts laid out as the JAX package's
pytrees ([K, N] weights, heads as [B, S, H, D]). Prefill attention is the
reference's pair-scan blockwise form with an online-softmax carry (a Python
loop over the (q-chunk, kv-chunk) pairs the mask admits); decode attention is
the grouped-GQA masked softmax over the cache. Linear sites go through the
reuse engine when a reuse context is threaded (`_maybe_reuse_matmul`).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import f32_product

Params = dict[str, Any]


# ---------------------------------------------------------------- init utils

def _dense_init(gen: torch.Generator, shape: tuple, *, lead: tuple = (),
                dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Normal / sqrt(fan_in) (fan_in = shape[0]), drawn in f32 from `gen`,
    with `lead` stacked dimensions in front."""
    t = torch.randn((*lead, *shape), generator=gen, device=device,
                    dtype=torch.float32)
    return t.mul_(1.0 / math.sqrt(shape[0])).to(dtype)


# ---------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def init_norm(d: int, kind: str = "rms", *, lead: tuple = (),
              device="cuda") -> Params:
    """rms: a zero scale (rms_norm multiplies by 1 + scale); otherwise a
    layer norm's unit scale and zero bias."""
    def full(v):
        return torch.full((*lead, d), v, dtype=torch.float32, device=device)

    if kind == "rms":
        return {"scale": full(0.0)}
    return {"scale": full(1.0), "bias": full(0.0)}


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ----------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D] rotated by angles [..., S, D/2] (half-split)."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the D/2 frequency slots are cut into
    (temporal, height, width) sections, each rotated by its own position
    stream. positions: [3, ..., S] (for text the three streams coincide and
    M-RoPE is RoPE). Each slot's stream is picked by slicing, so no index
    tensor is made from host data."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover "
                         f"{d // 2} frequency slots")
    freqs = rope_freqs(d, theta, x.device)
    pos = torch.cat([positions[i][..., None].expand(*positions.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1)  # [..., S, D/2]
    return _rotate(x, pos.float() * freqs)


def _mrope_sections(cfg: ModelConfig):
    half = cfg.head_dim // 2
    t = half - 2 * (3 * half // 8)
    return (t, 3 * half // 8, 3 * half // 8)


# ------------------------------------------------------------------ attention

def init_attention(cfg: ModelConfig, gen: torch.Generator, *,
                   lead: tuple = (), device="cuda") -> Params:
    """The attention block's parameters as the reference lays them out
    (wqkv [d, q + 2·kv], wo [q, d], the pre-norm; the QKV bias and the
    q/k norms where the config has them), with `lead` stacked dimensions."""
    d = cfg.d_model
    p: Params = {
        "wqkv": _dense_init(gen, (d, cfg.q_dim + 2 * cfg.kv_dim), lead=lead,
                            dtype=cfg.dtype, device=device),
        "wo": _dense_init(gen, (cfg.q_dim, d), lead=lead, dtype=cfg.dtype,
                          device=device),
        "norm": init_norm(d, lead=lead, device=device),
    }
    if cfg.qkv_bias:
        p["bqkv"] = torch.zeros((*lead, cfg.q_dim + 2 * cfg.kv_dim),
                                dtype=torch.float32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(cfg.head_dim, lead=lead, device=device)
        p["k_norm"] = init_norm(cfg.head_dim, lead=lead, device=device)
    return p


def _split_qkv(cfg: ModelConfig, qkv: torch.Tensor):
    q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    b, s = q.shape[:2]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _chunk_pairs(n_q, n_kv, chunk_q, chunk_kv, *, causal, window, q_offset=0):
    """Static (q-chunk, kv-chunk) pair list admitted by the mask."""
    pairs = []
    for i in range(n_q):
        q_lo = q_offset + i * chunk_q
        q_hi = q_lo + chunk_q - 1
        for j in range(n_kv):
            k_lo = j * chunk_kv
            k_hi = k_lo + chunk_kv - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            pairs.append((i, j))
    return pairs


def blockwise_attention(
    q: torch.Tensor,   # [B, Sq, H, D]
    k: torch.Tensor,   # [B, Skv, KV, D]
    v: torch.Tensor,
    *,
    causal: bool,
    window: int | None = None,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Pair-scan attention with an online softmax, grouped GQA."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    chunk_q = min(chunk_q, sq)
    chunk_kv = min(chunk_kv, skv)
    while sq % chunk_q:
        chunk_q -= 1
    while skv % chunk_kv:
        chunk_kv -= 1
    nq, nkv = sq // chunk_q, skv // chunk_kv
    pairs = _chunk_pairs(nq, nkv, chunk_q, chunk_kv, causal=causal,
                         window=window, q_offset=q_offset)
    q_sc = (q.float() * scale).to(q.dtype)
    out = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dev = q.device
    for idx, (i, j) in enumerate(pairs):
        if idx == 0 or pairs[idx - 1][0] != i:
            m = torch.full((b, h, chunk_q), -math.inf, device=dev)
            l = torch.zeros((b, h, chunk_q), device=dev)
            acc = torch.zeros((b, h, chunk_q, d), device=dev)
        qc = q_sc[:, i * chunk_q:(i + 1) * chunk_q].float()
        kc = k[:, j * chunk_kv:(j + 1) * chunk_kv].float()
        vc = v[:, j * chunk_kv:(j + 1) * chunk_kv].float()
        qg = qc.reshape(b, chunk_q, kv, rep, d)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc).reshape(b, h, chunk_q, chunk_kv)
        qpos = q_offset + i * chunk_q + torch.arange(chunk_q, device=dev)
        kpos = j * chunk_kv + torch.arange(chunk_kv, device=dev)
        masked = torch.zeros((chunk_q, chunk_kv), dtype=torch.bool, device=dev)
        if causal:
            masked = masked | (qpos[:, None] < kpos[None, :])
        if window is not None:
            masked = masked | (kpos[None, :] <= qpos[:, None] - window)
        s = s.masked_fill(masked[None, None], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        pg = p.reshape(b, kv, rep, chunk_q, chunk_kv)
        upd = torch.einsum("bgrqk,bkgd->bgrqd", pg, vc).reshape(b, h, chunk_q, d)
        acc = acc * alpha[..., None] + upd
        m = m_new
        if idx == len(pairs) - 1 or pairs[idx + 1][0] != i:
            safe_l = torch.clamp(l, min=1e-30)
            out[:, i * chunk_q:(i + 1) * chunk_q] = (
                acc / safe_l[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, KV, D] (new token already inserted)
    v_cache: torch.Tensor,
    length: torch.Tensor,   # [] valid length, a device scalar
) -> torch.Tensor:
    """Single-token grouped-GQA attention over the cache: q reshaped to
    [B, 1, KV, rep, D] contracts against the cache directly (no repeat)."""
    b, s, kv, d = k_cache.shape
    h = q.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    invalid = torch.arange(s, device=q.device) >= length
    qg = q.reshape(b, 1, kv, rep, d).float() * scale
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float())
    logits = logits.masked_fill(invalid, -math.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def _maybe_reuse_matmul(name, x, w, b, reuse_ctx):
    """Route a linear site through the ReuseEngine when serving with reuse;
    otherwise a plain product (prefill), outside any reuse kernel."""
    if reuse_ctx is not None:
        engine, cache, stats = reuse_ctx
        if name in cache:
            out, _, st = engine.apply(name, x, w, b, cache[name])
            stats[name] = st
            return out
    if b is None:
        return torch.matmul(x, w).to(x.dtype)
    # f32 product, then the bias, then one rounding (the reference's
    # preferred_element_type=f32 einsum plus bias)
    out = f32_product(x.reshape(-1, x.shape[-1]), w) + b.float()
    return out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def attention_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # [B, S, d]
    *,
    layer_window: int | None = None,     # None = full; int = sliding window
    positions: torch.Tensor,             # [B, S] ([3, B, S] for M-RoPE)
    kv_cache: dict | None = None,        # {"k": [B,Sc,KV,D], "v": ...} (views)
    kv_len: torch.Tensor | None = None,  # [] valid length before this token
    reuse_ctx=None,
    site_prefix: str = "attn",
) -> torch.Tensor:
    """Attention block (causal; full, or a sliding window of
    `layer_window`). A given `kv_cache` is updated IN PLACE. Prefill writes
    slots [0, S); a windowed layer whose window fits the cache keeps it
    rolling (token t at slot t % cache_len), so a prompt of S >= cache_len
    leaves its last cache_len tokens there. Decode writes one slot: len %
    cache_len on a rolling cache, else min(len, cache_len - 1). The softmax
    over the valid slots does not depend on their order, and RoPE is applied
    before the cache at absolute positions, so decode needs no window mask:
    a rolling cache of `window` slots holds exactly the window. With
    `kv_cache_quant` the cache holds int8 codes: decode attends over the
    dequantized cache, prefill over its own unquantized K/V."""
    b, s, _ = x.shape
    h = apply_norm(p["norm"], x, cfg.norm_eps)
    qkv = _maybe_reuse_matmul(f"{site_prefix}_qkv", h, p["wqkv"],
                              p.get("bqkv"), reuse_ctx)
    q, k, v = _split_qkv(cfg, qkv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, _mrope_sections(cfg))
        k = apply_mrope(k, positions, cfg.rope_theta, _mrope_sections(cfg))

    def to_cache(t):
        """The cache's layout: KV heads duplicated to kv_heads_eff
        (`kv_head_pad_to`), each head repeated in place, as the reference's
        `jnp.repeat` on the head axis; with `kv_cache_quant`, int8 codes at
        `kv_quant_scale` (torch.round rounds half to even, as jnp.round)."""
        if cfg.kv_heads_eff != cfg.n_kv_heads:
            t = torch.repeat_interleave(
                t, cfg.kv_heads_eff // cfg.n_kv_heads, dim=2)
        if cfg.kv_cache_quant:
            t = torch.clamp(torch.round(t.float() / cfg.kv_quant_scale),
                            -127, 127).to(torch.int8)
        return t

    def from_cache(t):
        if cfg.kv_cache_quant:
            return (t.float() * cfg.kv_quant_scale).to(x.dtype)
        return t

    if kv_cache is None or s > 1:
        out = blockwise_attention(
            q, k, v, causal=cfg.causal, window=layer_window,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        )
        if kv_cache is not None:
            k, v = to_cache(k), to_cache(v)
            cache_len = kv_cache["k"].shape[1]
            rolling = layer_window is not None and layer_window <= cache_len
            if rolling and s >= cache_len:
                # positions s - cache_len .. s - 1 land at their slots t %
                # cache_len: the tail of the prompt, rotated
                r = s % cache_len
                kv_cache["k"].copy_(torch.roll(k[:, s - cache_len:], r, 1))
                kv_cache["v"].copy_(torch.roll(v[:, s - cache_len:], r, 1))
            else:
                n = min(s, cache_len)
                kv_cache["k"][:, :n] = k[:, :n]
                kv_cache["v"][:, :n] = v[:, :n]
    else:
        cache_len = kv_cache["k"].shape[1]
        if layer_window is not None and layer_window <= cache_len:
            slot = torch.remainder(kv_len, cache_len)
        else:
            slot = torch.clamp(kv_len, max=cache_len - 1)
        slot = slot.reshape(1).long()
        kv_cache["k"].index_copy_(1, slot, to_cache(k))
        kv_cache["v"].index_copy_(1, slot, to_cache(v))
        out = decode_attention(q, from_cache(kv_cache["k"]),
                               from_cache(kv_cache["v"]), kv_len + 1)

    out = out.reshape(b, s, cfg.q_dim)
    out = _maybe_reuse_matmul(f"{site_prefix}_out", out, p["wo"], None, reuse_ctx)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ mlp

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None,
             *, lead: tuple = (), device="cuda") -> Params:
    """The MLP's parameters: wi [d, 2f] ([gate | up]) for swiglu, else
    [d, f]; wo [f, d]; the pre-norm."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    fi = 2 * f if cfg.mlp_kind == "swiglu" else f
    return {
        "wi": _dense_init(gen, (d, fi), lead=lead, dtype=cfg.dtype,
                          device=device),
        "wo": _dense_init(gen, (f, d), lead=lead, dtype=cfg.dtype,
                          device=device),
        "norm": init_norm(d, lead=lead, device=device),
    }


def mlp_forward(
    p: Params, cfg: ModelConfig, x: torch.Tensor, *, reuse_ctx=None,
    site_prefix: str = "mlp",
) -> torch.Tensor:
    h = apply_norm(p["norm"], x, cfg.norm_eps)
    hi = _maybe_reuse_matmul(f"{site_prefix}_in", h, p["wi"], None, reuse_ctx)
    if cfg.mlp_kind == "swiglu":
        gate, up = torch.chunk(hi, 2, dim=-1)  # [gate | up]
        act = F.silu(gate.float()).to(x.dtype) * up
    elif cfg.mlp_kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        act = F.gelu(hi.float(), approximate="tanh").to(x.dtype)
    elif cfg.mlp_kind == "relu2":
        r = torch.clamp(hi.float(), min=0.0)
        act = (r * r).to(x.dtype)
    else:
        raise ValueError(cfg.mlp_kind)
    out = _maybe_reuse_matmul(f"{site_prefix}_out", act, p["wo"], None, reuse_ctx)
    return out.to(x.dtype)
