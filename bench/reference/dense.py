"""Plain reference of the dense decoder (nemotron-4-15b's block: pre-norm
GQA attention with RoPE, a squared-ReLU or swiglu MLP, an untied head).

`logits(params, cfg, tokens, n_prompt)` runs one cohort's whole sequence
(its prompt, then the tokens fed to its decode steps) layer by layer, and
returns the f32 logits at the positions that served a token: the prompt's
last position and every decode position. Each of the four linear sites of a
layer is `common.reuse_linear`; the prompt's attention rounds the scaled
query to bf16 as a prefill does, a decode position attends with the f32
scaled query over the keys up to itself.
"""

from __future__ import annotations

import math

import torch

from bench.reference.common import (Precision, mm_f32_nd, reuse_linear,
                                    rms_norm, rope)


def _attention(q, k, v, n_prompt: int) -> torch.Tensor:
    """Causal grouped attention. q [B, T, H, D], k/v [B, T, KV, D] (bf16);
    returns [B, T, H, D] in q's dtype."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(d)
    qs = q.float() * scale
    # prompt positions: the scaled query rounded to bf16 (the prefill)
    qs[:, :n_prompt] = qs[:, :n_prompt].to(q.dtype).float()
    qg = qs.reshape(b, t, kvh, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(causal, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _mlp_act(hi: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu2":
        r = torch.clamp(hi.float(), min=0.0)
        return (r * r).to(hi.dtype)
    if kind == "swiglu":
        gate, up = torch.chunk(hi, 2, dim=-1)
        return torch.nn.functional.silu(gate.float()).to(hi.dtype) * up
    raise ValueError(f"mlp kind {kind!r}")


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, n_prompt: int,
           prec: Precision = Precision()) -> torch.Tensor:
    """f32 logits [B, T - n_prompt + 1, V] at positions n_prompt-1 .. T-1,
    every product in the precision `prec` (the embedding is read as it
    is)."""
    scale = cfg["reuse"]["fixed_scale"]
    eps = cfg["norm_eps"]
    nh, kvh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    blocks = params["blocks"]
    x = params["embed"][tokens.long()]
    b, t, _ = x.shape
    for layer in range(cfg["n_layers"]):
        a = {k: v[layer] if k != "norm" else v["scale"][layer]
             for k, v in blocks["attn"].items()}
        m = {k: v[layer] if k != "norm" else v["scale"][layer]
             for k, v in blocks["mlp"].items()}
        h = rms_norm(x, a["norm"], eps)
        qkv = reuse_linear(h, a["wqkv"], n_prompt, scale, prec)
        q, k, v = torch.split(qkv, [nh * hd, kvh * hd, kvh * hd], dim=-1)
        q = rope(q.reshape(b, t, nh, hd), cfg["rope_theta"])
        k = rope(k.reshape(b, t, kvh, hd), cfg["rope_theta"])
        v = v.reshape(b, t, kvh, hd)
        o = _attention(q, k, v, n_prompt).reshape(b, t, nh * hd)
        x = x + reuse_linear(o, a["wo"], n_prompt, scale, prec)
        h = rms_norm(x, m["norm"], eps)
        act = _mlp_act(reuse_linear(h, m["wi"], n_prompt, scale, prec),
                       cfg["mlp_kind"])
        x = x + reuse_linear(act, m["wo"], n_prompt, scale, prec)
    h = rms_norm(x[:, n_prompt - 1:], params["final_norm"]["scale"], eps)
    return mm_f32_nd(h, params["lm_head"], prec)
