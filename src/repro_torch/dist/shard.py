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
mesh (`NamedSharding`, `cache_shardings`). Without a process group a mesh
of `host:N` is N shard lanes on the serve's one device (`launch/mesh.py`),
and `cache_shard_axes` names each leaf's shard axis, with nothing moved.
Under a process group (`torchrun`, one process a card) rank r holds shard
`r % S` (`Placement`): its cache keeps only its own block of the shard
axis, of size 1 (`cache_shardings`), each site call computes its own panel
and all-gathers the panels into the output over the model group (an
activation collective, as the reference's GSPMD step makes), and the host
reads that rebuild the one-device layout of the shard lanes go through one
collective and one device→host copy (`host_arrays`).
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


# numpy dtype of a leaf's host copy (bf16 has none: its values as f32)
_HOST_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                torch.bfloat16: np.float32, torch.int8: np.int8,
                torch.int16: np.int16, torch.int32: np.int32,
                torch.int64: np.int64, torch.uint8: np.uint8,
                torch.bool: np.bool_}


@dataclasses.dataclass(frozen=True)
class Placement:
    """One rank's place on a mesh under a process group: its rank and the
    world's size, the model axis's width, the process group of its data
    row's model axis (None: the default group, when the model axis spans
    the world) and its device. It holds model-axis shard `rank % n_shards`,
    following the reference's row-major (data, model) device order."""

    rank: int
    world: int
    n_shards: int
    group: Any = None
    device: torch.device = torch.device("cpu")

    @property
    def shard(self) -> int:
        return self.rank % self.n_shards

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[S, *t.shape]: every shard's `t`, in shard order, from one
        all-gather over the model group (a collective every rank of the
        group must make, in the same order)."""
        src = t.reshape(-1) if t.ndim == 0 else t.contiguous()
        out = torch.empty((self.n_shards * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        torch.distributed.all_gather_into_tensor(out, src, group=self.group)
        return out.view(self.n_shards, *t.shape)

    def gather_lanes(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """`t` (a leaf of this rank's cache, its shard axis `axis` of size
        1) with the shard axis rebuilt from every shard: the one-device
        layout, on the device."""
        return torch.cat(list(self.all_gather(t).unbind(0)), dim=axis)

    def world_agrees(self, data: bytes) -> bool:
        """Whether every rank of the world holds the same `data` (32 bytes
        or fewer, e.g. a digest): one all-gather over the default group."""
        t = torch.zeros(32, dtype=torch.uint8, device=self.device)
        t[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        out = torch.empty(32 * self.world, dtype=torch.uint8,
                          device=self.device)
        torch.distributed.all_gather_into_tensor(out, t)
        rows = out.view(self.world, 32).cpu()
        return bool((rows == rows[0]).all())


def host_arrays(leaves: list[torch.Tensor], axes: list[int | None],
                placement: Placement | None = None) -> list[np.ndarray]:
    """Host copies of `leaves` in the one-device layout, from ONE
    device→host copy: the leaves are packed into one f64 vector (exact for
    every cache dtype) and copied once. With `placement` (one shard a card)
    the vector is first all-gathered over the model group, and a leaf with
    a shard axis (`axes[i]`, of size 1 here) is rebuilt along it from every
    shard's block; a replicated one (None) is shard 0's. Without it every
    shard lane is already here and `axes` changes nothing."""
    if not leaves:
        return []
    flat = torch.cat([t.reshape(-1).double() for t in leaves])
    rows = (flat.cpu().numpy()[None] if placement is None
            else placement.all_gather(flat).cpu().numpy())
    out, pos = [], 0
    for t, ax in zip(leaves, axes):
        n, shape = t.numel(), tuple(t.shape)
        blocks = [r[pos:pos + n].reshape(shape) for r in rows]
        pos += n
        a = blocks[0] if ax is None or len(blocks) == 1 else np.concatenate(
            blocks, axis=ax)
        out.append(a.astype(_HOST_DTYPES[t.dtype]))
    return out


@dataclasses.dataclass(frozen=True)
class ShardBlock:
    """A rank's block of a leaf's shard axis, kept at size 1: the port's
    counterpart of a `NamedSharding` whose spec puts "model" on `axis`."""

    axis: int
    index: int

    def take(self, leaf):
        """The block of `leaf` (a tensor view, or a numpy copy)."""
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(self.axis, self.index, 1)
        return np.take(leaf, [self.index], axis=self.axis)


def cache_shardings(engine, mesh, cache: dict[str, Any]) -> dict[str, Any]:
    """The reference's `cache_shardings` on a placed mesh (one process a
    card): for every tensor leaf of a sharded site, the rank's block of the
    shard axis (`ShardBlock`, size 1: the reference's per-device local
    shape); None for every leaf of an unsharded site, and for the host
    mirror `mode_host`, which every rank keeps whole (replicated).
    `cache` may be in the one-device layout or the placed one: the blocks
    are named from the plan, nothing moves."""
    placement = getattr(mesh, "placement", None)
    if placement is None:
        raise ValueError(
            "cache_shardings needs a placed mesh (one process a card, under "
            "a process group); a mesh of lanes on one device names its "
            "shard axes with cache_shard_axes")
    model_size = int(mesh.shape["model"])

    def name_blocks(tree, block):
        if isinstance(tree, dict):
            return {k: name_blocks(v, block) for k, v in tree.items()}
        return block if isinstance(tree, (torch.Tensor, np.ndarray)) else None

    out: dict[str, Any] = {}
    for name, entry in cache.items():
        n_shards = engine.shards.get(name)
        if not n_shards:
            out[name] = name_blocks(entry, None)
            continue
        if n_shards != model_size:
            raise ValueError(
                f"site {name!r} is planned for {n_shards} shards but the "
                f"mesh model axis is {model_size} wide")
        out[name] = name_blocks(entry, ShardBlock(
            shard_axis_of(engine.stacking.get(name, 0)), placement.shard))
        if "mode_host" in entry:
            out[name]["mode_host"] = None
    return out


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
    n_shards: int | None = None,
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
    these. A placed cache (one shard a card, its shard axes of size 1)
    gives its global shapes through `n_shards`, the model axis's width."""
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
        if n_shards:
            sigs.add((dt, shape[:ax] + (n_shards,) + shape[ax + 1:]))

    for name, entry in cache.items():
        add(entry, (shard_axes or {}).get(name))
    return sigs
