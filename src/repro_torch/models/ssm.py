"""RWKV6 (Finch) time mix and channel mix, and the Mamba2 block, as the JAX
package's `models.ssm`.

Token shift with data-dependent (LoRA) mixing, a data-dependent per-channel
decay w_t, the bonus u and a per-head state S ∈ R^{dk×dv}:

    out_t = r_t · (diag(u)·k_tᵀ v_t + S_t);   S_{t+1} = diag(w_t)·S_t + k_tᵀ v_t

The recurrence over the S tokens of a call is a Python loop that runs one
`ops.wkv6_decode` step per token, so prefill (S > 1) and decode (S = 1) both
go through the kernel. The state passed in is a layer's lane of the stacked
decode state and is updated IN PLACE: the wkv lane by the kernel, the token
shift lanes by a copy of the last token.

Mamba2 (the zamba2 hybrid's blocks): a depthwise causal conv of width 4 over
[x | B | C], a per-head scalar decay exp(softplus(dt)·A) and the selective
state h ∈ R^{hd×state} per head,

    h_t = decay_t·h_{t-1} + (dt_t·x_t) ⊗ B_t;   y_t = h_t·C_t + D·x_t

run one token at a time in the reference's step order (its chunked scan is
a rematerialisation device for training and keeps that order), for prefill
and decode alike. The conv state and h are written in place. Its
projections run without reuse, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.reuse_cache import kernel_impl
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, _maybe_reuse_matmul, rms_norm

RWKV_LORA = 32
RWKV_DECAY_LORA = 64


def init_rwkv6(cfg: ModelConfig, gen: torch.Generator, *, layers: int,
               device) -> Params:
    """Random parameters of `layers` stacked RWKV6 blocks ([L, ...] leaves),
    made on `device` at the reference's scales: normal/sqrt(fan_in) for the
    projections, normal·0.01 for the second LoRA factors, decay_base −6, and
    zeros for the norm scales, `maa_*` and `bonus`."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.ssm_head_dim
    n_h = d // hd
    dt = cfg.dtype

    def normal(*shape, scale):
        t = torch.randn((layers, *shape), generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(scale).to(dt)

    def dense(*shape):
        return normal(*shape, scale=1.0 / math.sqrt(shape[0]))

    def f32(*shape, fill=0.0):
        return torch.full((layers, *shape), fill, dtype=torch.float32,
                          device=device)

    def norm():
        return {"scale": f32(d)}

    return {
        "norm1": norm(),
        "norm2": norm(),
        "tmix": {
            "maa_x": f32(d),
            "maa_wkvrg": f32(5, d),
            "tm_w1": dense(d, 5 * RWKV_LORA),
            "tm_w2": normal(5, RWKV_LORA, d, scale=0.01),
            "td_w1": dense(d, RWKV_DECAY_LORA),
            "td_w2": normal(RWKV_DECAY_LORA, d, scale=0.01),
            "decay_base": f32(d, fill=-6.0),
            "wr": dense(d, d),
            "wk": dense(d, d),
            "wv": dense(d, d),
            "wg": dense(d, d),
            "wo": dense(d, d),
            "bonus": f32(n_h, hd),
            "ln_x": norm(),
        },
        "cmix": {
            "maa_k": f32(d),
            "maa_r": f32(d),
            "wk": dense(d, f),
            "wv": dense(f, d),
            "wr": dense(d, d),
        },
    }


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result (the reference's preferred_element_type=f32):
    products of bf16 values are exact in f32."""
    return a.float() @ b.float()


def _rwkv_projections(p: Params, cfg: ModelConfig, x, x_shift, reuse_ctx,
                      prefix):
    """Token-shift mixing + r/k/v/g/decay projections. x: [B, S, d]."""
    tm = p["tmix"]
    dt = x.dtype
    sx = x_shift - x
    xxx = x + sx * tm["maa_x"].to(dt)
    router = torch.tanh(_mm_f32(xxx, tm["tm_w1"])).reshape(
        *x.shape[:2], 5, RWKV_LORA)
    mix = torch.einsum("bsfl,fld->bsfd", router.to(dt).float(),
                       tm["tm_w2"].float()).to(dt)
    maa = tm["maa_wkvrg"].to(dt)
    xw, xk, xv, xr, xg = [x + sx * (maa[i] + mix[:, :, i]) for i in range(5)]
    r = _maybe_reuse_matmul(f"{prefix}_wr", xr, tm["wr"], None, reuse_ctx)
    k = _maybe_reuse_matmul(f"{prefix}_wk", xk, tm["wk"], None, reuse_ctx)
    v = _maybe_reuse_matmul(f"{prefix}_wv", xv, tm["wv"], None, reuse_ctx)
    g = F.silu(_maybe_reuse_matmul(f"{prefix}_wg", xg, tm["wg"], None,
                                   reuse_ctx).float()).to(dt)
    decay_in = torch.tanh(_mm_f32(xw, tm["td_w1"]))
    decay = tm["decay_base"] + _mm_f32(decay_in.to(dt), tm["td_w2"])
    w = torch.exp(-torch.exp(decay.float()))  # [B, S, d] in (0, 1)
    return r, k, v, g, w


def rwkv6_time_mix(
    p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
    reuse_ctx=None, prefix: str = "rwkv",
) -> tuple[torch.Tensor, dict]:
    """x: [B, S, d]; state: {"shift": [B, d], "wkv": [B, H, dk, dv] f32},
    both updated in place. The wkv step runs on the reuse engine's substrate
    when reuse is on, else on "cuda" (the kernel on CUDA tensors, its plain
    version on CPU tensors)."""
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    n_h = d // hd
    tm = p["tmix"]
    impl = (kernel_impl(reuse_ctx[0].impl) if reuse_ctx is not None
            else "cuda")

    x_shift = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    r, k, v, g, w = _rwkv_projections(p, cfg, x, x_shift, reuse_ctx, prefix)
    rh, kh, vh = (a.reshape(b, s, n_h, hd).float() for a in (r, k, v))
    wh = w.reshape(b, s, n_h, hd)
    u = tm["bonus"].float()
    out = torch.stack([
        ops.wkv6_decode(rh[:, t], kh[:, t], vh[:, t], wh[:, t], u,
                        state["wkv"], impl=impl)
        for t in range(s)], dim=1).reshape(b, s, d)

    out = rms_norm(out.to(x.dtype), tm["ln_x"]["scale"], cfg.norm_eps) * g
    out = _maybe_reuse_matmul(f"{prefix}_wo", out, tm["wo"], None, reuse_ctx)
    state["shift"].copy_(x[:, -1])
    return out.to(x.dtype), state


def rwkv6_channel_mix(
    p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
    reuse_ctx=None, prefix: str = "rwkv_cmix",
) -> tuple[torch.Tensor, dict]:
    """x: [B, S, d]; state: {"shift": [B, d]}, updated in place."""
    cm = p["cmix"]
    dt = x.dtype
    x_shift = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    sx = x_shift - x
    xk = x + sx * cm["maa_k"].to(dt)
    xr = x + sx * cm["maa_r"].to(dt)
    k = _maybe_reuse_matmul(f"{prefix}_wk", xk, cm["wk"], None, reuse_ctx)
    k = torch.square(torch.relu(k.float())).to(dt)
    kv = _maybe_reuse_matmul(f"{prefix}_wv", k, cm["wv"], None, reuse_ctx)
    r = _maybe_reuse_matmul(f"{prefix}_wr", xr, cm["wr"], None, reuse_ctx)
    out = torch.sigmoid(r.float()).to(dt) * kv
    state["shift"].copy_(x[:, -1])
    return out, state


def init_rwkv6_state(cfg: ModelConfig, batch: int, *, layers: int | None = None,
                     device="cuda") -> dict:
    """Zero state; with `layers`, stacked [L, ...] as the decode state."""
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    lead = () if layers is None else (layers,)
    return {
        "tmix": {
            "shift": torch.zeros((*lead, batch, d), dtype=cfg.dtype,
                                 device=device),
            "wkv": torch.zeros((*lead, batch, d // hd, hd, hd),
                               dtype=torch.float32, device=device),
        },
        "cmix": {"shift": torch.zeros((*lead, batch, d), dtype=cfg.dtype,
                                      device=device)},
    }


# ------------------------------------------------------------------- Mamba2

MAMBA_CONV_K = 4


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, *, lead: tuple,
                device) -> Params:
    """Random parameters of Mamba2 blocks stacked over `lead` ([nsb, 6] in
    the hybrid), made on `device` at the reference's scales:
    normal/sqrt(fan_in) projections, conv weights normal·0.1, zero conv
    bias, A_log and dt_bias, D one, zero norm scales."""
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * st

    def normal(*shape, scale):
        t = torch.randn((*lead, *shape), generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(scale).to(cfg.dtype)

    def f32(*shape, fill=0.0):
        return torch.full((*lead, *shape), fill, dtype=torch.float32,
                          device=device)

    return {
        "norm": {"scale": f32(d)},
        "in_proj": normal(d, 2 * di + 2 * st + nh, scale=1.0 / math.sqrt(d)),
        "conv_w": normal(MAMBA_CONV_K, conv_ch, scale=0.1),
        "conv_b": f32(conv_ch),
        "A_log": f32(nh),
        "D": f32(nh, fill=1.0),
        "dt_bias": f32(nh),
        "out_norm": {"scale": f32(di)},
        "out_proj": normal(di, d, scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor):
    """Depthwise causal conv of width K in x's dtype, the taps summed in
    order. x: [B, S, C]; conv_state: [B, K-1, C]. Returns (out, the new
    conv state: the last K-1 inputs)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, :s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, s:]


def mamba2_forward(
    p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
    reuse_ctx=None, prefix: str = "mamba",
) -> tuple[torch.Tensor, dict]:
    """x: [B, S, d]; state: {"conv": [B, K-1, C], "h": [B, nh, hd, state]
    f32}, both updated in place."""
    b, s, _ = x.shape
    di, st, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_head_dim)
    dt_ = x.dtype
    hin = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    zxbcdt = _maybe_reuse_matmul(f"{prefix}_in", hin, p["in_proj"], None,
                                 reuse_ctx)
    z, xc, bc, cc, dt = torch.split(zxbcdt, [di, di, st, st, nh], dim=-1)
    conv_out, conv_state = _causal_conv(torch.cat([xc, bc, cc], dim=-1),
                                        p["conv_w"], p["conv_b"],
                                        state["conv"])
    conv_out = F.silu(conv_out.float()).to(dt_)
    xc, bc, cc = torch.split(conv_out, [di, st, st], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                    # [B, S, nh]
    decay = torch.exp(dt * -torch.exp(p["A_log"]))                # [B, S, nh]
    xh = xc.reshape(b, s, nh, hd).float()
    bf, cf = bc.float(), cc.float()
    h = state["h"]
    ys = []
    for t in range(s):
        dx = dt[:, t, :, None] * xh[:, t]                         # [B, nh, hd]
        h = (decay[:, t, :, None, None] * h
             + dx[..., :, None] * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhps,bs->bhp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + p["D"][:, None] * xh             # [B, S, nh, hd]
    y = rms_norm(y.reshape(b, s, di).to(dt_), p["out_norm"]["scale"],
                 cfg.norm_eps)
    y = y * F.silu(z.float()).to(dt_)
    out = _maybe_reuse_matmul(f"{prefix}_out", y, p["out_proj"], None,
                              reuse_ctx)
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out.to(dt_), state


def init_mamba2_state(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                      device="cuda") -> dict:
    """Zero state, stacked over `lead` ([nsb, 6] as the decode state)."""
    di, st = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((*lead, batch, MAMBA_CONV_K - 1, di + 2 * st),
                            dtype=cfg.dtype, device=device),
        "h": torch.zeros((*lead, batch, cfg.n_ssm_heads, cfg.ssm_head_dim, st),
                         dtype=torch.float32, device=device),
    }
