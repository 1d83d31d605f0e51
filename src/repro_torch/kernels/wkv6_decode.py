"""Fused RWKV6 decode step (the rwkv6 time mix's recurrence, one token).

    kv  = kᵀ v                         per (batch, head), [dk, dv]
    out = Σ_k r · (diag(u)·kv + S)     the readout, [dv]
    S'  = diag(w)·S + kv               the decay update

`wkv6_decode` launches `csrc/wkv6_decode.cu` on CUDA tensors, which writes
S' IN PLACE into the given state (the port's decode state is updated in
place: the state passed is a layer's lane of the stacked [L, ...] tensor) or,
given `state_out`, into that tensor; it takes the plain version
`wkv6_decode_torch` on CPU tensors, copying its S' the same way.
`wkv6_decode_torch` is the reference's `wkv6_decode_ref` math, op for op,
and returns a new state.

Training: `WKV6Sequence` is the recurrence over a sequence as a
`torch.autograd.Function`. Its forward steps `wkv6_decode` from states[t]
into states[t+1] of one [S+1, B, H, dk, dv] buffer, which it saves; its
backward steps `wkv6_decode_backward` (`csrc/wkv6_backward.cu`, plain version
`wkv6_decode_backward_torch`) from t = S-1 down to 0, carrying ∂L/∂S in
place. The reference has no such kernel: XLA differentiates its `lax.scan`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend

THREADS = 256   # csrc/wkv6_decode.cu and csrc/wkv6_backward.cu kThreads
MAX_DK = 1024   # kMaxDk
WARP = 32       # the backward reduces a state row inside a warp


def wkv6_decode_torch(
    r: torch.Tensor,      # [B, H, dk]
    k: torch.Tensor,      # [B, H, dk]
    v: torch.Tensor,      # [B, H, dv]
    w: torch.Tensor,      # [B, H, dk]  per-channel decay in (0, 1)
    u: torch.Tensor,      # [H, dk]     bonus
    state: torch.Tensor,  # [B, H, dk, dv] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version. Returns (out [B, H, dv] f32, new state); `state` is not
    written."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       u.float()[None, :, :, None] * kv + state)
    s_new = wf[..., :, None] * state + kv
    return out, s_new


def _check(what, r, k, v, w, u, state, **extra) -> None:
    """The CUDA kernels' contract: f32, contiguous, 16-byte aligned tensors
    on r's device, at r's [B, H, dk] and v's dv; `extra` names more tensors
    with the shape of r ("dk"), v ("dv") or the state ("state")."""
    b, h, dk = r.shape
    dv = v.shape[-1]
    like = {"dk": (b, h, dk), "dv": (b, h, dv), "state": (b, h, dk, dv)}
    shapes = {"r": (r, (b, h, dk)), "k": (k, (b, h, dk)), "v": (v, (b, h, dv)),
              "w": (w, (b, h, dk)), "u": (u, (h, dk)),
              "state": (state, (b, h, dk, dv)),
              **{n: (t, like[kind]) for n, (t, kind) in extra.items()}}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{what}: {name} on {t.device}, r on {r.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
    if dv % 4 or THREADS % (dv // 4) or dk > MAX_DK:
        raise ValueError(f"{what}: the CUDA kernel needs dv % 4 == 0, "
                         f"{THREADS} % (dv / 4) == 0 and dk <= {MAX_DK}; got "
                         f"dk={dk}, dv={dv}")


def wkv6_decode(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
    state_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step. Returns (out [B, H, dv] f32, S'), with S' written into
    `state_out`, or into `state` in place when it is None (the returned
    state is that tensor). `state_out` must not overlap `state`."""
    dest = state if state_out is None else state_out
    if r.device.type == "cpu":
        out, s_new = wkv6_decode_torch(r, k, v, w, u, state)
        dest.copy_(s_new)
        return out, dest
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_decode: unsupported device {r.device}")
    _check("wkv6_decode", r, k, v, w, u, state, state_out=(dest, "state"))
    b, h, dk = r.shape
    dv = v.shape[-1]
    out = torch.empty((b, h, dv), dtype=torch.float32, device=r.device)
    rc = backend.library("wkv6_decode").rt_wkv6_decode(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), dest.data_ptr(), out.data_ptr(), b * h, h, dk, dv,
        backend.stream_ptr(r.device),
    )
    backend.check(rc, "wkv6_decode")
    backend.count_launch("wkv6_decode")
    return out, dest


def wkv6_decode_backward_torch(
    r: torch.Tensor,        # [B, H, dk]
    k: torch.Tensor,        # [B, H, dk]
    v: torch.Tensor,        # [B, H, dv]
    w: torch.Tensor,        # [B, H, dk]
    u: torch.Tensor,        # [H, dk]
    state: torch.Tensor,    # [B, H, dk, dv] f32, the step's input state S
    g_out: torch.Tensor,    # [B, H, dv] f32, ∂L/∂out
    g_state: torch.Tensor,  # [B, H, dk, dv] f32, ∂L/∂S'
):
    """Plain version of the step's gradient. Returns (r̄, k̄, v̄, w̄, ū per
    batch row [B, H, dk], S̄ = ∂L/∂S); nothing is written."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None]
    kv = kf[..., :, None] * vf[..., None, :]
    g_r = torch.einsum("bhv,bhkv->bhk", g_out, uf[..., None] * kv + state)
    g_u = rf * kf * (g_out * vf).sum(-1)[..., None]
    g_kv = (rf * uf)[..., :, None] * g_out[..., None, :] + g_state
    g_k = (g_kv * vf[..., None, :]).sum(-1)
    g_v = (g_kv * kf[..., :, None]).sum(-2)
    g_w = (g_state * state).sum(-1)
    g_s = rf[..., :, None] * g_out[..., None, :] + wf[..., :, None] * g_state
    return g_r, g_k, g_v, g_w, g_u, g_s


def wkv6_decode_backward(r, k, v, w, u, state, g_out, g_state):
    """The step's gradient. Returns (r̄, k̄, v̄, w̄, ū per batch row
    [B, H, dk]) and writes S̄ = ∂L/∂S into `g_state` in place: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if r.device.type == "cpu":
        *grads, g_s = wkv6_decode_backward_torch(r, k, v, w, u, state, g_out,
                                                 g_state)
        g_state.copy_(g_s)
        return tuple(grads)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_decode_backward: unsupported device {r.device}")
    _check("wkv6_decode_backward", r, k, v, w, u, state,
           g_out=(g_out, "dv"), g_state=(g_state, "state"))
    b, h, dk = r.shape
    dv = v.shape[-1]
    if WARP % (dv // 4):
        raise ValueError(f"wkv6_decode_backward: the CUDA kernel needs dv / 4 "
                         f"to divide {WARP}; got dv={dv}")
    g_r, g_k, g_w, g_u = (torch.empty_like(r) for _ in range(4))
    g_v = torch.empty_like(v)
    rc = backend.library("wkv6_backward").rt_wkv6_decode_backward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), g_out.data_ptr(), g_state.data_ptr(),
        g_r.data_ptr(), g_k.data_ptr(), g_v.data_ptr(), g_w.data_ptr(),
        g_u.data_ptr(), b * h, h, dk, dv, backend.stream_ptr(r.device),
    )
    backend.check(rc, "wkv6_decode_backward")
    backend.count_launch("wkv6_decode_backward")
    return g_r, g_k, g_v, g_w, g_u


class WKV6Sequence(torch.autograd.Function):
    """The recurrence over S tokens with its gradient: apply(r, k, v, w, u,
    s0) with r, k, w [B, S, H, dk], v [B, S, H, dv], u [H, dk] and the
    initial state s0 [B, H, dk, dv], all f32. Returns (out [B, S, H, dv],
    S_T).

    The forward steps `wkv6_decode` from states[t] into states[t+1] of one
    [S+1, B, H, dk, dv] buffer and saves it (under per-layer
    rematerialisation it lives for one layer's backward); the backward steps
    `wkv6_decode_backward` for t = S-1 ... 0. ū sums the per-batch partials
    of every step in one reduction, in a fixed order."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        rt, kt, vt, wt = (a.transpose(0, 1).contiguous().float()
                          for a in (r, k, v, w))
        u = u.contiguous().float()
        s = rt.shape[0]
        states = torch.empty((s + 1, *s0.shape), dtype=torch.float32,
                             device=s0.device)
        states[0].copy_(s0)
        outs = torch.empty((s, *vt.shape[1:]), dtype=torch.float32,
                           device=s0.device)
        for t in range(s):
            o, _ = wkv6_decode(rt[t], kt[t], vt[t], wt[t], u, states[t],
                               states[t + 1])
            outs[t].copy_(o)
        ctx.save_for_backward(rt, kt, vt, wt, u, states)
        return outs.transpose(0, 1).contiguous(), states[s].clone()

    @staticmethod
    def backward(ctx, g_out, g_last):
        rt, kt, vt, wt, u, states = ctx.saved_tensors
        s = rt.shape[0]
        g_state = (torch.zeros_like(states[0]) if g_last is None
                   else g_last.float().contiguous().clone())
        if g_out is None:
            g_out = torch.zeros((rt.shape[1], s, *vt.shape[2:]),
                                dtype=torch.float32, device=rt.device)
        go = g_out.float().transpose(0, 1).contiguous()
        g_r, g_k, g_w, g_u = (torch.empty_like(rt) for _ in range(4))
        g_v = torch.empty_like(vt)
        for t in range(s - 1, -1, -1):
            outs = wkv6_decode_backward(rt[t], kt[t], vt[t], wt[t], u,
                                        states[t], go[t], g_state)
            for buf, val in zip((g_r, g_k, g_v, g_w, g_u), outs):
                buf[t].copy_(val)
        grads = [a.transpose(0, 1) for a in (g_r, g_k, g_v, g_w)]
        return (*grads, g_u.sum(dim=(0, 1)), g_state)
