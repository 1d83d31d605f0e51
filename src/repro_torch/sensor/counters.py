"""Per-site sensor counters — the measured reuse accounting (unsharded).

The counters ride inside each reuse-cache entry under "sensor" and are
updated in place on the device by every site evaluation, from the tile mask:

* tile counters are exact integers on the padded tile grid:
  ``skipped_tiles + computed_tiles == steps · gm · gk``;
* weight bytes are priced against the dense baseline, which streams the
  site's [K, N] panel once per m-row-block per step;
* ``dma_issued_tiles``, ``grid_steps`` and ``overflow_fallbacks`` come from
  the accounting functions of `kernels/ops.py`, never from a kernel.

Dtypes and arithmetic follow `repro.sensor.counters`, so after the same
evaluations every counter is bitwise equal to the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core.similarity import fma_f32

COUNTER_KEYS = (
    "skipped_tiles", "computed_tiles", "skipped_macs", "computed_macs",
    "skipped_weight_bytes", "total_weight_bytes", "reused_out_elems",
    "dma_issued_tiles", "grid_steps", "overflow_fallbacks", "mode_flag",
    "mode_transitions", "suppressed_flips", "sentinel_trips",
    "slot_hit_sum", "slot_steps",
)


def init_site_counters(batch: int, *, device) -> dict[str, torch.Tensor]:
    """Fresh counters for one reuse site."""
    def z(dtype, shape=()):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return {
        "skipped_tiles": z(i32),
        "computed_tiles": z(i32),
        "skipped_macs": z(f32),
        "computed_macs": z(f32),
        "skipped_weight_bytes": z(f32),
        "total_weight_bytes": z(f32),
        "reused_out_elems": z(f32),
        "dma_issued_tiles": z(i32),
        "grid_steps": z(f32),
        "overflow_fallbacks": z(i32),
        # kernelMode tracking: -1 = never evaluated, 0 = basic, 1 = reuse
        "mode_flag": torch.full((), -1, dtype=i32, device=device),
        "mode_transitions": z(i32),
        "suppressed_flips": z(i32),
        "sentinel_trips": z(i32),
        "slot_hit_sum": z(f32, (batch,)),
        "slot_steps": z(i32, (batch,)),
    }


def _mode_bookkeeping(sensor: dict, flag: int) -> None:
    prev = sensor["mode_flag"]
    flipped = (prev >= 0) & (prev != flag)
    sensor["mode_transitions"].add_(flipped.to(torch.int32))
    sensor["mode_flag"].fill_(flag)


def _add_hits(sensor: dict, row_matches: torch.Tensor, k: int) -> None:
    """slot_hit_sum += row similarity, as one FMA of the match count and
    f32(1/k), the rounding of the reference's compiled step."""
    sensor["slot_hit_sum"].copy_(
        fma_f32(row_matches, 1.0 / k, sensor["slot_hit_sum"]))
    sensor["slot_steps"].add_(1)


def update_on_reuse(
    sensor: dict[str, torch.Tensor],
    *,
    block_mask: torch.Tensor,   # [gm, gk] int32; 1 = tile computed
    row_matches: torch.Tensor,  # [M] f32 count of unchanged codes per row
    k: int,
    block_m: int,
    block_k: int,
    n: int,
    gn: int,
    w_itemsize: int,
    dma_issued: torch.Tensor | None = None,
    grid_steps: torch.Tensor | None = None,
    overflow: torch.Tensor | None = None,
) -> None:
    """Account one reuse-mode evaluation from its tile mask (in place)."""
    gm, gk = block_mask.shape
    computed = block_mask.sum(dtype=torch.int32)
    skipped = gm * gk - computed
    macs_per_tile = float(block_m * block_k * n)
    tile_w_bytes = float(block_k * n * w_itemsize)
    rows_all_skipped = (block_mask == 0).all(dim=1).sum().float()
    s = sensor
    s["skipped_tiles"].add_(skipped)
    s["computed_tiles"].add_(computed)
    s["skipped_macs"].add_(skipped.float() * macs_per_tile)
    s["computed_macs"].add_(computed.float() * macs_per_tile)
    s["skipped_weight_bytes"].add_(skipped.float() * tile_w_bytes)
    s["total_weight_bytes"].add_(float(gm * gk) * tile_w_bytes)
    s["reused_out_elems"].add_(rows_all_skipped * float(block_m * n))
    s["dma_issued_tiles"].add_(
        dma_issued.to(torch.int32) if dma_issued is not None else computed * gn)
    if grid_steps is not None:
        s["grid_steps"].add_(grid_steps.float())
    else:
        s["grid_steps"].add_(float(gm * gk * gn))
    if overflow is not None:
        s["overflow_fallbacks"].add_(overflow.to(torch.int32))
    _mode_bookkeeping(s, 1)
    _add_hits(s, row_matches, k)


def update_on_basic(
    sensor: dict[str, torch.Tensor],
    *,
    row_matches: torch.Tensor,
    m: int,
    k: int,
    n: int,
    gn: int,
    block_m: int,
    block_k: int,
    w_itemsize: int,
) -> None:
    """Account one basic-mode (reuse-OFF) evaluation: everything computed,
    every weight tile streamed (in place)."""
    gm = -(-m // block_m)
    gk = -(-k // block_k)
    total = gm * gk
    macs_per_tile = float(block_m * block_k * n)
    tile_w_bytes = float(block_k * n * w_itemsize)
    s = sensor
    s["computed_tiles"].add_(total)
    s["computed_macs"].add_(float(total) * macs_per_tile)
    s["total_weight_bytes"].add_(float(total) * tile_w_bytes)
    s["dma_issued_tiles"].add_(gm * gk * gn)
    s["grid_steps"].add_(float(gm * gk * gn))
    _mode_bookkeeping(s, 0)
    _add_hits(s, row_matches, k)
