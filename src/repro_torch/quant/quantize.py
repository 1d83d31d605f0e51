"""Symmetric int8 quantization (zero-point 0, per-tensor scale).

Similarity is defined in the int8 code domain, and symmetric quantization
keeps the delta algebra exact: dequant(q_c) - dequant(q_p) = scale·(q_c - q_p),
so the delta is exactly zero wherever codes match.
"""

from __future__ import annotations

import torch

INT8_MIN = -127  # symmetric: reserve -128 so |q| <= 127 and -q is representable
INT8_MAX = 127


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 codes. A true f32 division by the scale, then round half to
    even (`torch.round`), as `jnp.round` does."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
