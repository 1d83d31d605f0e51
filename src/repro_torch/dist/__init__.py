"""repro_torch.dist — model-axis sharding of the reuse state.

`repro_torch.dist.shard` plans shard-local site specs, names the shard axis
of every leaf of a sharded cache, and gives the cache leaves' shape
signatures that the no-gather check (`repro_torch.roofline.collectives`)
matches copies against.
"""

from repro_torch.dist.shard import (  # noqa: F401
    cache_shape_signatures,
    cache_shard_axes,
    plan_local_spec,
    shard_axis_of,
    shard_view,
    validate_shardable,
)
