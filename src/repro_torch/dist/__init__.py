"""repro_torch.dist — model-axis sharding of the reuse state.

`repro_torch.dist.shard` plans shard-local site specs, names the shard axis
of every leaf of a sharded cache (and, one shard a card, each rank's block
of it: `cache_shardings`), holds a rank's `Placement` and its collectives,
and gives the cache leaves' shape signatures that the no-gather check
(`repro_torch.roofline.collectives`) matches copies and collectives
against.
"""

from repro_torch.dist.shard import (  # noqa: F401
    Placement,
    ShardBlock,
    cache_shape_signatures,
    cache_shard_axes,
    cache_shardings,
    host_arrays,
    plan_local_spec,
    shard_axis_of,
    shard_view,
    validate_shardable,
)
