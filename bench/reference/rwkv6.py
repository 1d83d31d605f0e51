"""Plain reference of RWKV-6 (Finch): token shift with data-dependent
(LoRA) mixing, data-dependent decay, the WKV recurrence per head

    out_t = r_t · (diag(u)·k_tᵀ v_t + S_t);   S_{t+1} = diag(w_t)·S_t + k_tᵀ v_t

and the channel mix with a squared-ReLU key and a sigmoid receptance.

`logits(params, cfg, tokens, n_prompt)` runs one cohort's whole sequence
from a zero state, layer by layer, and returns the f32 logits at the prompt's
last position and every decode position. The eight linear sites of a layer
(r, k, v, g, o of the time mix; k, v, r of the channel mix) are
`common.reuse_linear`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import (Precision, mm_f32_nd, reuse_linear,
                                    rms_norm)


def _f32mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Both operands widened to f32, one f32 product (no TF32)."""
    return a.float() @ b.float()


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x delayed by one position, a zero vector first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u) -> torch.Tensor:
    """The recurrence over T from S = 0. r, k, v, w [B, T, H, D] f32,
    u [H, D]. Returns out [B, T, H, D] f32."""
    b, t, h, d = r.shape
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    uu = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, i], uu * kv + s))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1)


def _time_mix(p: dict, cfg: dict, xn: torch.Tensor, n_prompt: int,
              scale: float, prec: Precision) -> torch.Tensor:
    dt = xn.dtype
    b, t, d = xn.shape
    hd = cfg["head_size"]
    lora = cfg["time_mix_lora"]
    sx = _shift(xn) - xn
    xxx = xn + sx * p["maa_x"].to(dt)
    router = torch.tanh(_f32mm(xxx, p["tm_w1"])).reshape(b, t, 5, lora)
    mix = torch.einsum("bsfl,fld->bsfd", router.to(dt).float(),
                       p["tm_w2"].float()).to(dt)
    maa = p["maa_wkvrg"].to(dt)
    xw, xk, xv, xr, xg = [xn + sx * (maa[i] + mix[:, :, i]) for i in range(5)]
    r = reuse_linear(xr, p["wr"], n_prompt, scale, prec)
    k = reuse_linear(xk, p["wk"], n_prompt, scale, prec)
    v = reuse_linear(xv, p["wv"], n_prompt, scale, prec)
    g = F.silu(reuse_linear(xg, p["wg"], n_prompt, scale, prec).float()).to(dt)
    dec_in = torch.tanh(_f32mm(xw, p["td_w1"]))
    decay = p["decay_base"] + _f32mm(dec_in.to(dt), p["td_w2"])
    w = torch.exp(-torch.exp(decay.float()))
    heads = [a.reshape(b, t, d // hd, hd).float() for a in (r, k, v)]
    out = _wkv(*heads, w.reshape(b, t, d // hd, hd), p["bonus"])
    out = rms_norm(out.reshape(b, t, d).to(dt), p["ln_x"]["scale"],
                   cfg["norm_eps"]) * g
    return reuse_linear(out, p["wo"], n_prompt, scale, prec)


def _channel_mix(p: dict, xn: torch.Tensor, n_prompt: int,
                 scale: float, prec: Precision) -> torch.Tensor:
    dt = xn.dtype
    sx = _shift(xn) - xn
    xk = xn + sx * p["maa_k"].to(dt)
    xr = xn + sx * p["maa_r"].to(dt)
    k = reuse_linear(xk, p["wk"], n_prompt, scale, prec)
    k = torch.square(torch.relu(k.float())).to(dt)
    kv = reuse_linear(k, p["wv"], n_prompt, scale, prec)
    r = reuse_linear(xr, p["wr"], n_prompt, scale, prec)
    return torch.sigmoid(r.float()).to(dt) * kv


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, n_prompt: int,
           prec: Precision = Precision()) -> torch.Tensor:
    """f32 logits [B, T - n_prompt + 1, V] at positions n_prompt-1 .. T-1,
    every product of a linear site and the head in the precision `prec`
    (the embedding and the f32 LoRA products are as they are)."""
    scale = cfg["reuse"]["fixed_scale"]
    eps = cfg["norm_eps"]
    x = params["embed"][tokens.long()]
    stack = params["blocks"]["rwkv"]
    for layer in range(cfg["n_layers"]):
        p = _layer(stack, layer)
        x = x + _time_mix(p["tmix"], cfg,
                          rms_norm(x, p["norm1"]["scale"], eps), n_prompt,
                          scale, prec)
        x = x + _channel_mix(p["cmix"],
                             rms_norm(x, p["norm2"]["scale"], eps), n_prompt,
                             scale, prec)
    h = rms_norm(x[:, n_prompt - 1:], params["final_norm"]["scale"], eps)
    return mm_f32_nd(h, params["lm_head"], prec)
