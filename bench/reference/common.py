"""Plain PyTorch pieces of the references: products, norms, RoPE, and the
reuse site written as the paper's recurrence.

Nothing here imports the program. The dtypes follow what the configuration
states: bf16 weights and activations between operations, f32 inside norms,
RoPE and softmax, and f32 accumulation in every product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference computes its products: `w` maps each weight matrix
    as it is read, `a` each activation operand of a product (the prompt's
    input and each Δ), `mm` is the f32-result product. The default is the
    configuration's own precision."""

    w: Callable = _same
    a: Callable = _same
    mm: Callable = None

    def product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (self.mm or mm_f32)(a, b)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N] with an f32 result. Products of bf16 values are exact
    in f32, so on the card one bf16 product with an f32 output; elsewhere
    both operands widened to f32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def mm_f32_nd(x: torch.Tensor, w: torch.Tensor,
              prec: Precision = Precision()) -> torch.Tensor:
    """x [..., K] times w [K, N], f32 result [..., N]."""
    lead = x.shape[:-1]
    x2 = prec.a(x.reshape(-1, x.shape[-1]).contiguous())
    return prec.product(x2, prec.w(w)).reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale), in f32, rounded to x's
    dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, T, H, D] at positions 0..T-1, half-split
    pairs (i, i + D/2), angles in f32."""
    d = x.shape[-1]
    t = x.shape[1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    pos = torch.arange(t, dtype=torch.int32, device=x.device).float()
    ang = pos[:, None] * freqs                       # [T, D/2]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def reuse_linear(x: torch.Tensor, w: torch.Tensor, n_prompt: int,
                 scale: float, prec: Precision = Precision()) -> torch.Tensor:
    """One linear site over a cohort's whole sequence x [B, T, K].

    The prompt's positions (the prefill) are the plain product, rounded to
    x's dtype. Each later position t is a decode step of the reuse
    recurrence, started from a zero state at the first decode step:

        q_t = clip(round(x_t / s), ±127)            int8 codes
        Δ_t = ((q_t − q_{t−1}) · s) in the weight's dtype, q_0 = 0
        O_t = O_{t−1} + Δ_t · W   (f32),  O_0 = 0

    and the site's output is O_t rounded to x's dtype. Tiles whose codes
    did not change contribute Δ = 0, so this is the result of any tile
    skipping that is sound."""
    b, t, k = x.shape
    n = w.shape[-1]
    w = prec.w(w)
    parts = []
    if n_prompt:
        parts.append(torch.matmul(prec.a(x[:, :n_prompt]), w).to(x.dtype))
    if t > n_prompt:
        s = torch.tensor(scale, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(x[:, n_prompt:].float() / s), -127, 127)
        prev = torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], dim=1)
        delta = prec.a(((q - prev) * s).to(w.dtype))
        p = prec.product(delta.reshape(-1, k), w).reshape(b, t - n_prompt, n)
        parts.append(torch.cumsum(p, dim=1).to(x.dtype))
    return torch.cat(parts, dim=1)


def fp8(w: torch.Tensor) -> torch.Tensor:
    """w through float8 e4m3 with one scale per matrix (per layer of a
    stacked leaf; one for a whole activation operand), back in w's dtype.
    f32 tensors and vectors pass as they are."""
    if w.dtype != torch.bfloat16 or w.ndim < 2:
        return w
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    out = torch.empty_like(flat)
    for i in range(flat.shape[0]):
        m = flat[i].float()
        amax = torch.clamp(m.abs().amax(), min=1e-30)
        sc = 448.0 / amax
        out[i] = ((m * sc).to(torch.float8_e4m3fn).float() / sc).to(w.dtype)
    return out.reshape(*lead, *w.shape[-2:])


def _fp8_act(x: torch.Tensor) -> torch.Tensor:
    return fp8(x.reshape(1, -1, x.shape[-1])).reshape(x.shape)


def _f32_reordered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


PRECISIONS = {
    # the configuration's precision: bf16 operands, f32 accumulation
    "bf16": Precision(),
    # the control: every product computed in float8 (e4m3), weights and
    # activation operands alike, as an fp8 GEMM takes them
    "fp8": Precision(w=fp8, a=_fp8_act),
    # the configuration's precision with the products' sums taken in
    # another order (f32 operands): a witness of how far two sound
    # orders of the same sums drift apart
    "bf16_reordered": Precision(mm=_f32_reordered),
}
