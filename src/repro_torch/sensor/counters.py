"""Per-site sensor counters — the measured reuse accounting.

The counters ride inside each reuse-cache entry under "sensor" and are
updated in place on the device by every site evaluation, from the tile mask:

* tile counters are exact integers on the padded tile grid:
  ``skipped_tiles + computed_tiles == steps · gm · gk``;
* weight bytes are priced against the dense baseline, which streams the
  site's [K, N] panel once per m-row-block per step;
* ``dma_issued_tiles``, ``grid_steps`` and ``overflow_fallbacks`` come from
  the accounting functions of `kernels/ops.py`, never from a kernel.

Model-axis sharding (the ownership partition, `ReuseEngine.shard_sites`):
every shard sees the same replicated delta and mask, so the accounting is
partitioned instead of counted S times. Shard s counts the k-tile columns
with ``col % S == s`` priced at the global N (``ShardCtx.n_total``), and the
global n-panels with ``panel % S == s`` for dma and grid steps (the
per-panel formulas at gn = 1 times `owned_panel_count`);
``reused_out_elems`` prices the shard's local N. The plain sum over shards
is then the unsharded counter bitwise. `COUNTER_SHARD_REDUCE` says, per
counter, whether the shards' lanes sum or are replicated ("first").

Dtypes and arithmetic follow `repro.sensor.counters`, so after the same
evaluations every counter is bitwise equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.similarity import fma_f32


class ShardCtx(NamedTuple):
    """One shard of a model-sharded site evaluation: its position on the
    model axis and the geometry of the global site it belongs to."""

    index: int      # this shard's position on the model axis
    count: int      # number of shards the site is split into
    n_total: int    # global out_features (the shard computes n_total/count)
    gn_total: int   # global n-panel count: ceil(n_total / block_n)


# How each counter collapses across model-axis shards: "sum" lanes are
# disjoint slices of the dense baseline (their plain sum is the global
# value, bitwise); "first" lanes are replicated (any one shard).
COUNTER_SHARD_REDUCE: dict[str, str] = {
    "skipped_tiles": "sum",
    "computed_tiles": "sum",
    "skipped_macs": "sum",
    "computed_macs": "sum",
    "skipped_weight_bytes": "sum",
    "total_weight_bytes": "sum",
    "reused_out_elems": "sum",
    "dma_issued_tiles": "sum",
    "grid_steps": "sum",
    "overflow_fallbacks": "first",
    "mode_flag": "first",
    "mode_transitions": "first",
    "suppressed_flips": "first",
    "sentinel_trips": "first",
    "slot_hit_sum": "first",
    "slot_steps": "first",
}


def owned_k_mask(gk: int, shard: ShardCtx, device=None) -> torch.Tensor:
    """bool [gk]: the k-tile columns shard `index` accounts (col % S == s)."""
    return (torch.arange(gk, device=device) % shard.count) == shard.index


def owned_k_count(gk: int, shard: ShardCtx) -> int:
    """How many of the gk k-tile columns shard `index` accounts."""
    return sum(1 for c in range(gk) if c % shard.count == shard.index)


def owned_panel_count(shard: ShardCtx) -> int:
    """How many GLOBAL n-panels shard `index` accounts (p % S == s)."""
    return sum(1 for p in range(shard.gn_total)
               if p % shard.count == shard.index)

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
    shard: ShardCtx | None = None,
) -> None:
    """Account one reuse-mode evaluation from its tile mask (in place).
    With `shard`, the owned k-tile columns at the global N; the caller then
    passes `dma_issued` and `grid_steps` already ownership-scaled."""
    gm, gk = block_mask.shape
    if shard is None:
        computed = block_mask.sum(dtype=torch.int32)
        total = gm * gk
        n_acct = n
    else:
        if dma_issued is None or grid_steps is None:
            raise ValueError("sharded accounting needs ownership-scaled "
                             "dma_issued and grid_steps")
        own = owned_k_mask(gk, shard, block_mask.device)
        computed = (block_mask * own[None, :]).sum(dtype=torch.int32)
        total = gm * owned_k_count(gk, shard)
        n_acct = shard.n_total
    skipped = total - computed
    macs_per_tile = float(block_m * block_k * n_acct)
    tile_w_bytes = float(block_k * n_acct * w_itemsize)
    rows_all_skipped = (block_mask == 0).all(dim=1).sum().float()
    s = sensor
    s["skipped_tiles"].add_(skipped)
    s["computed_tiles"].add_(computed)
    s["skipped_macs"].add_(skipped.float() * macs_per_tile)
    s["computed_macs"].add_(computed.float() * macs_per_tile)
    s["skipped_weight_bytes"].add_(skipped.float() * tile_w_bytes)
    s["total_weight_bytes"].add_(float(total) * tile_w_bytes)
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
    shard: ShardCtx | None = None,
) -> None:
    """Account one basic-mode (reuse-OFF) evaluation: everything computed,
    every weight tile streamed (in place). With `shard`, the ownership
    partition of `update_on_reuse`: owned k-tile columns at the global N,
    owned global n-panels for dma and grid steps."""
    gm = -(-m // block_m)
    gk = -(-k // block_k)
    if shard is None:
        total, n_acct, panels = gm * gk, n, gn
    else:
        total = gm * owned_k_count(gk, shard)
        n_acct, panels = shard.n_total, owned_panel_count(shard)
    macs_per_tile = float(block_m * block_k * n_acct)
    tile_w_bytes = float(block_k * n_acct * w_itemsize)
    s = sensor
    s["computed_tiles"].add_(total)
    s["computed_macs"].add_(float(total) * macs_per_tile)
    s["total_weight_bytes"].add_(float(total) * tile_w_bytes)
    s["dma_issued_tiles"].add_(gm * gk * panels)
    s["grid_steps"].add_(float(gm * gk * panels))
    _mode_bookkeeping(s, 0)
    _add_hits(s, row_matches, k)
