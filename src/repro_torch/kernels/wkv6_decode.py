"""Fused RWKV6 decode step (the rwkv6 time mix's recurrence, one token).

    kv  = kᵀ v                         per (batch, head), [dk, dv]
    out = Σ_k r · (diag(u)·kv + S)     the readout, [dv]
    S'  = diag(w)·S + kv               the decay update

`wkv6_decode` launches `csrc/wkv6_decode.cu` on CUDA tensors, which writes
S' IN PLACE into the given state (the port's decode state is updated in
place: the state passed is a layer's lane of the stacked [L, ...] tensor),
and takes the plain version `wkv6_decode_torch` on CPU tensors, copying its
S' into the state. `wkv6_decode_torch` is the reference's `wkv6_decode_ref`
math, op for op, and returns a new state.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend

THREADS = 256   # csrc/wkv6_decode.cu kThreads
MAX_DK = 1024   # kMaxDk


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


def _check(r, k, v, w, u, state) -> None:
    b, h, dk = r.shape
    dv = v.shape[-1]
    shapes = {"r": (r, (b, h, dk)), "k": (k, (b, h, dk)), "v": (v, (b, h, dv)),
              "w": (w, (b, h, dk)), "u": (u, (h, dk)),
              "state": (state, (b, h, dk, dv))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv6_decode: {name} {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_decode: {name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"wkv6_decode: {name} on {t.device}, r on {r.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv6_decode: {name} must be contiguous and "
                             "16-byte aligned")
    if dv % 4 or THREADS % (dv // 4) or dk > MAX_DK:
        raise ValueError(f"wkv6_decode: the CUDA kernel needs dv % 4 == 0, "
                         f"{THREADS} % (dv / 4) == 0 and dk <= {MAX_DK}; got "
                         f"dk={dk}, dv={dv}")


def wkv6_decode(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step. Returns (out [B, H, dv] f32, state), with S' written into
    `state` in place (the returned state is the same tensor)."""
    if r.device.type == "cpu":
        out, s_new = wkv6_decode_torch(r, k, v, w, u, state)
        state.copy_(s_new)
        return out, state
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_decode: unsupported device {r.device}")
    _check(r, k, v, w, u, state)
    b, h, dk = r.shape
    dv = v.shape[-1]
    out = torch.empty((b, h, dv), dtype=torch.float32, device=r.device)
    rc = backend.library("wkv6_decode").rt_wkv6_decode(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), out.data_ptr(), b * h, h, dk, dv,
        backend.stream_ptr(r.device),
    )
    backend.check(rc, "wkv6_decode")
    backend.count_launch("wkv6_decode")
    return out, state
