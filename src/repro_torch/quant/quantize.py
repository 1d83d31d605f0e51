"""Symmetric int8 quantization (zero-point 0, per-tensor or per-channel scale).

Similarity is defined in the int8 code domain, and symmetric quantization
keeps the delta algebra exact: dequant(q_c) - dequant(q_p) = scale·(q_c - q_p),
so the delta is exactly zero wherever codes match.
"""

from __future__ import annotations

import dataclasses

import torch

INT8_MIN = -127  # symmetric: reserve -128 so |q| <= 127 and -q is representable
INT8_MAX = 127


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization configuration for one tensor site."""

    bits: int = 8
    per_channel: bool = False
    channel_axis: int = -1
    # Scales are calibrated from data (max-abs) or fixed ahead of time.
    fixed_scale: float | None = None

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def calibrate_scale(x: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """Max-abs scale so that x/scale spans the int range: an f32 scalar, or
    one scale per channel along `spec.channel_axis`."""
    if spec.fixed_scale is not None:
        return torch.tensor(spec.fixed_scale, dtype=torch.float32,
                            device=x.device)
    if spec.per_channel:
        axis = spec.channel_axis % x.ndim
        axes = tuple(a for a in range(x.ndim) if a != axis)
        amax = torch.amax(torch.abs(x), dim=axes) if axes else torch.abs(x)
    else:
        amax = torch.amax(torch.abs(x))
    amax = torch.clamp(amax.float(), min=1e-8)
    return amax / spec.qmax


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 codes. A true f32 division by the scale, then round half to
    even (`torch.round`), as `jnp.round` does."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def fake_quantize(x: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """Quantize and dequantize: the float tensor the quantized model sees.
    The scale broadcasts against x as the reference's does (a per-channel
    scale along the last axis)."""
    scale = calibrate_scale(x, spec)
    return dequantize_int8(quantize_int8(x, scale), scale, dtype=x.dtype)
