"""Model-axis sharding of the reuse cache — plan, placement, shape evidence.

The rule is the reference's (`repro.dist.shard`): reuse state lives with the
weights it shadows. A site's [K, N] weight splits N-ways on the mesh's
"model" axis; shard s owns the columns `[s·N/S, (s+1)·N/S)` and, with
them, the only N-shaped cache leaf, `prev_out`. Every M- or K-shaped leaf
(`prev_q`, `scale`, `sim_ema`, `steps`, the ctrl lanes, the sensor
counters) is replicated per shard: the quantize → delta → mask path needs
the whole K row and runs identically on every shard, so nothing crosses
shards in a step. The shard axis sits inside the layer axis ([L, S, ...]
stacked, [S, ...] unstacked), so layer l's view is a clean [S, ...] block.

The counters' ownership partition (`repro_torch.sensor.counters`) makes
the per-shard lanes disjoint slices of the dense-baseline accounting: their
plain sum is the unsharded counter, bitwise.

Placement. The reference places each shard's slice on its own device of a
mesh (`NamedSharding`). Here a mesh of `host:N` is N shard lanes on the
serve's one device (`launch/mesh.py`), so placement is naming: each leaf's
shard axis, with nothing moved. One shard a card (`torch.distributed`) is
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.reuse_cache import ReuseSiteSpec
from repro_torch.sensor.counters import (  # noqa: F401  (one import site)
    COUNTER_SHARD_REDUCE,
    ShardCtx,
    owned_k_mask,
    owned_panel_count,
)


def validate_shardable(spec: ReuseSiteSpec, n_shards: int) -> None:
    """Raise with an actionable message when a site can't split N-ways."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if spec.out_features % n_shards:
        raise ValueError(
            f"site {spec.name!r}: out_features={spec.out_features} is not "
            f"divisible by {n_shards} model shards — pick a mesh whose model "
            f"axis divides every reuse site's N"
        )


def plan_local_spec(spec: ReuseSiteSpec, n_shards: int) -> ReuseSiteSpec:
    """The shard-local site spec: the same site with N/S output columns
    (block geometry, dataflow, exec path and budget do not depend on N)."""
    validate_shardable(spec, n_shards)
    return dataclasses.replace(
        spec, out_features=spec.out_features // n_shards)


def shard_axis_of(n_layers: int) -> int:
    """Position of the shard axis in a site's cache leaves: inside the layer
    axis ([L, S, ...] stacked, [S, ...] unstacked)."""
    return 1 if n_layers else 0


def shard_view(tree, axis: int, index: int):
    """Shard `index`'s lane of every leaf of a sharded entry (views of the
    tensors; numpy leaves, such as the mode mirror, the same)."""
    if isinstance(tree, dict):
        return {k: shard_view(v, axis, index) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.select(axis, index)
    return np.take(tree, index, axis=axis)


def cache_shard_axes(engine, mesh, cache: dict[str, Any]) -> dict[str, Any]:
    """The counterpart of the reference's `cache_shardings`: for every
    tensor leaf of the cache, the axis that sits on the mesh's "model" axis
    (None: replicated, as every leaf of an unsharded site is). The cache is
    already shard-expanded by `ReuseEngine.init_cache`, so this names axes
    and moves nothing."""
    model_size = int(mesh.shape["model"])
    out: dict[str, Any] = {}

    def name_axes(tree, ax):
        if isinstance(tree, dict):
            return {k: name_axes(v, ax) for k, v in tree.items()}
        return ax if isinstance(tree, torch.Tensor) else None

    for name, entry in cache.items():
        n_shards = engine.shards.get(name)
        if not n_shards:
            out[name] = name_axes(entry, None)
            continue
        if n_shards != model_size:
            raise ValueError(
                f"site {name!r} is planned for {n_shards} shards but the "
                f"mesh model axis is {model_size} wide")
        out[name] = name_axes(entry, shard_axis_of(
            engine.stacking.get(name, 0)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def cache_shape_signatures(
    cache: dict[str, Any], shard_axes: dict[str, Any] | None = None,
) -> set[tuple[str, tuple]]:
    """(dtype, dims) signatures of every cache leaf: its global shape and,
    for a sharded leaf (`shard_axes`, from `cache_shard_axes`), one shard's
    block as the reference's placement names it (the shard axis of size
    1). A step reads and writes one layer's lane of one shard at a time,
    so an operand of either shape is state moved across shards. A sharded
    leaf of one value a layer and shard (the counters, ctrl lanes, steps,
    scale: [L, S], as small as a batch of tokens) has no signature; the
    ctrl snapshot, outside the step, is what reduces them. The no-gather
    check flags any copy, cat or gather whose operand matches one of
    these."""
    sigs: set[tuple[str, tuple]] = set()

    def add(tree, axes):
        if isinstance(tree, dict):
            for k, v in tree.items():
                add(v, axes.get(k) if isinstance(axes, dict) else axes)
            return
        if not isinstance(tree, torch.Tensor):
            return
        dt = str(tree.dtype).removeprefix("torch.")
        shape = tuple(int(d) for d in tree.shape)
        ax = axes if isinstance(axes, int) else None
        if ax is not None and tree.ndim == ax + 1:
            return  # one value a layer and shard: see below
        sigs.add((dt, shape))
        if ax is None:
            return
        sigs.add((dt, shape[:ax] + (1,) + shape[ax + 1:]))

    for name, entry in cache.items():
        add(entry, (shard_axes or {}).get(name))
    return sigs
