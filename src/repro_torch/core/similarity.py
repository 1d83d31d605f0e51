"""Input similarity in the int8 code domain, and the tile-granular change mask.

Similarity between two consecutive evaluations of a layer is the fraction of
identical int8 codes at matching positions (paper Sec. II-B / III-A, Figs. 3
and 4). `similarity_breakdown` splits it into positions where both codes are
zero and identical-nonzero ones (Fig. 4: squared-ReLU and ReLU archs are
dominated by the zero part, GLU archs by the nonzero part). The skip
granularity of the reuse GEMM is a (block_m × block_k) tile, so
`block_zero_mask` marks the tiles with any changed code and
`harvestable_similarity` reports the share of tiles wholly unchanged: the
similarity a tile-granular skip can use.

The running lanes fed by a similarity (`sim_ema`, the ctrl occupancy, the
sensor's `slot_hit_sum`) are rounded as the reference's compiled step rounds
them. There XLA lowers a mean over n to `sum · f32(1/n)`, folds the constant
factors of an EMA into one f32 constant, and its CPU backend contracts the
multiply and the add that follows into one FMA (`vfmadd` in the compiled
object). `fma_f32` reproduces that single rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fma_f32(a: torch.Tensor, b: torch.Tensor | float,
            c: torch.Tensor) -> torch.Tensor:
    """f32 `a·b + c` rounded once, as a fused multiply-add. The product of
    two f32 values is exact in f64; the f64 sum is made round-to-odd (its
    exact error from TwoSum decides the last bit), and round-to-odd to 53
    bits followed by one rounding to 24 bits is the correctly rounded
    result. A non-finite sum is the FMA's as it is (an infinite operand
    makes TwoSum's error NaN). A float `b` stays a Python scalar (rounded to
    f32), so no host value is copied to the device."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor)
                      else float(np.float32(b)))
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    # one ulp toward the exact sum (err · inf is ±inf where err != 0)
    nudge = (err != 0) & even & torch.isfinite(s)
    s = torch.where(nudge, torch.nextafter(s, err * np.inf), s)
    return s.float()


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean of a 0/1 tensor as XLA lowers the reference's: the exact
    count times the f32 reciprocal of n."""
    return x.sum(dtype=torch.float32) * (1.0 / x.numel())


def code_similarity(cur_q: torch.Tensor, prev_q: torch.Tensor) -> torch.Tensor:
    """Fraction of positions whose int8 codes are identical. Scalar f32."""
    return _mean(cur_q == prev_q)


def similarity_breakdown(cur_q: torch.Tensor,
                         prev_q: torch.Tensor) -> dict[str, torch.Tensor]:
    """Fig.-4 split: identical-and-zero vs identical-and-nonzero fractions."""
    same = cur_q == prev_q
    zero = same & (cur_q == 0)
    nonzero = same & (cur_q != 0)
    n = cur_q.numel()
    return {
        "similarity": same.sum() / n,
        "zero_similarity": zero.sum() / n,
        "nonzero_similarity": nonzero.sum() / n,
    }


def row_code_matches(cur_q: torch.Tensor, prev_q: torch.Tensor) -> torch.Tensor:
    """Per-row count of identical codes, [M] f32 (exact)."""
    return (cur_q == prev_q).sum(dim=-1, dtype=torch.float32)


def row_code_similarity(cur_q: torch.Tensor, prev_q: torch.Tensor) -> torch.Tensor:
    """Per-row code-match fraction, [M] f32 — one similarity per serving slot.
    The exact match count times the f32 reciprocal of K, as XLA lowers the
    reference's mean (bitwise equal to it)."""
    return row_code_matches(cur_q, prev_q) * (1.0 / cur_q.shape[-1])


def block_zero_mask(delta: torch.Tensor, block_m: int, block_k: int) -> torch.Tensor:
    """int32 [ceil(M/bm), ceil(K/bk)]: 1 where the tile has any nonzero entry.

    M and K are padded virtually; padding positions count as unchanged.
    """
    m, k = delta.shape
    pm = (-m) % block_m
    pk = (-k) % block_k
    if pm or pk:
        delta = F.pad(delta, (0, pk, 0, pm))
    gm, gk = delta.shape[0] // block_m, delta.shape[1] // block_k
    tiles = delta.reshape(gm, block_m, gk, block_k)
    return (tiles != 0).any(dim=3).any(dim=1).to(torch.int32)


def harvestable_similarity(cur_q: torch.Tensor, prev_q: torch.Tensor,
                           block_m: int, block_k: int) -> torch.Tensor:
    """Fraction of (bm × bk) tiles fully unchanged — the similarity usable
    at tile granularity (paper: 'all deltas in the sub-vector must be
    zero')."""
    delta = cur_q.to(torch.int32) - prev_q.to(torch.int32)
    mask = block_zero_mask(delta, block_m, block_k)
    return 1.0 - _mean(mask)


def ema_update(stat: torch.Tensor, obs: torch.Tensor,
               decay: float) -> torch.Tensor:
    """Running similarity estimate used by the reuse policy, rounded as
    written (two products and a sum); `ema_update_mean` is the rounding the
    compiled step gives it."""
    return decay * stat + (1.0 - decay) * obs


def ema_update_mean(stat: torch.Tensor, total: torch.Tensor, n: int,
                    decay: float) -> torch.Tensor:
    """The running estimate the reuse policy reads, `decay·stat + (1 −
    decay)·total/n` (the reference's `ema_update` of a mean), as the
    reference's compiled step computes it: `fma(stat, decay, total·c)` with
    the folded constant `c = f32(1 − decay) · f32(1/n)` rounded to f32."""
    c = float(np.float32(1.0 - decay) * np.float32(1.0 / n))
    return fma_f32(stat, decay, total * c)
