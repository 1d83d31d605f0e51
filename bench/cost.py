"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes that a decode step and its kernels need, from the
configuration's shapes and the tiles the program computed.

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates: 989e12 bf16
FLOP/s, 3.35e12 B/s of HBM. A kernel's least time is the larger of its
operations over the first and its bytes over the second; each input byte is
counted read once and each output byte written once.

The reuse GEMM's work depends on the data: a computed tile (block_m rows ×
block_k of the input width) multiplies its Δ rows by the weight's block_k
rows across all N columns, so it reads block_k·N weights; a skipped tile
reads nothing. Every cell runs at most block_m rows, so one tile row spans
the batch and each computed tile's weights are read once.
"""

from __future__ import annotations

import dataclasses

from bench import families

PEAK_FLOPS = 989e12   # bf16 dense FLOP/s
PEAK_BYTES = 3.35e12  # HBM B/s

BF16, F32, I8 = 2, 4, 1


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    k: int          # in features
    n: int          # out features
    layers: int
    block_m: int
    block_k: int

    def gk(self) -> int:
        return -(-self.k // self.block_k)


def sites(cfg: dict) -> list[Site]:
    """The reuse sites the program registers for this configuration, with
    the configuration's shapes (its family's `site_shapes`)."""
    L = cfg["n_layers"]
    bm, bk = cfg["reuse"]["block_m"], cfg["reuse"]["block_k"]
    return [Site(name, k, n, L, bm, bk)
            for name, k, n in families.load(cfg["reference"]).site_shapes(cfg)]


def gemm_work(site: Site, computed_tiles: int, calls: int,
              rows: int) -> tuple[float, float]:
    """(FLOPs, bytes) of `calls` reuse GEMM calls of `site` at `rows` rows
    that computed `computed_tiles` tiles in all: the computed tiles' weights
    and Δ rows read, prev_out read and the output written (f32)."""
    r = min(rows, site.block_m)
    flops = 2.0 * computed_tiles * r * site.block_k * site.n
    byt = (computed_tiles * site.block_k * site.n * BF16
           + computed_tiles * r * site.block_k * BF16
           + 2.0 * calls * rows * site.n * F32)
    return flops, byt


def delta_quant_bytes(site: Site, calls: int, rows: int) -> float:
    """Bytes of `calls` fused delta/quant/account calls: x read (bf16), the
    previous codes read and the new ones written (int8), Δ written (bf16),
    the tile mask written (int32)."""
    gm = -(-rows // site.block_m)
    per = (rows * site.k * BF16 + 2 * rows * site.k * I8
           + rows * site.k * BF16 + gm * site.gk() * 4)
    return float(calls * per)


def wkv6_bytes(cfg: dict, calls: int, rows: int) -> float:
    """Bytes of `calls` WKV6 decode steps of one layer each: the f32 state
    read and written, r, k, v, w read and out written (f32), the bonus
    read."""
    d, hd = cfg["d_model"], cfg["head_size"]
    per = (2 * rows * d * hd * F32 + 5 * rows * d * F32 + d * F32)
    return float(calls * per)


def step_work(cfg: dict, gemm: dict[str, int], steps: int, rows: int,
              kv_len: float) -> tuple[float, float]:
    """(FLOPs, bytes) of `steps` whole decode steps: each reuse site at the
    tiles it computed (`gemm`: site name → computed tiles over the steps),
    the LM head, and what the family's `step_extra` adds (attention over
    `kv_len` cached positions, mean over the steps, or the recurrence)."""
    d, v = cfg["d_model"], cfg["vocab"]
    flops = byt = 0.0
    for s in sites(cfg):
        f, _ = gemm_work(s, gemm[s.name], steps * s.layers, rows)
        flops += f
        byt += gemm[s.name] * s.block_k * s.n * BF16
    ef, eb = families.load(cfg["reference"]).step_extra(cfg, rows, kv_len)
    per_flops = 2.0 * rows * d * v + ef
    per_bytes = float(d * v * BF16 + rows * d * BF16) + eb
    return flops + steps * per_flops, byt + steps * per_bytes


def least_seconds(flops: float, byt: float) -> float:
    return max(flops / PEAK_FLOPS, byt / PEAK_BYTES)
