"""RWKV6 (Finch) time mix and channel mix, as the JAX package's `models.ssm`.

Token shift with data-dependent (LoRA) mixing, a data-dependent per-channel
decay w_t, the bonus u and a per-head state S ∈ R^{dk×dv}:

    out_t = r_t · (diag(u)·k_tᵀ v_t + S_t);   S_{t+1} = diag(w_t)·S_t + k_tᵀ v_t

The recurrence over the S tokens of a call is a Python loop that runs one
`ops.wkv6_decode` step per token, so prefill (S > 1) and decode (S = 1) both
go through the kernel. The state passed in is a layer's lane of the stacked
decode state and is updated IN PLACE: the wkv lane by the kernel, the token
shift lanes by a copy of the last token.
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
