"""The reuse core: delta encoding, similarity, the per-site cache, the
policy and the engine, with the reference's exports (`repro.core`).
The leaf modules (similarity, delta, the cache and the policy) come first:
the kernels and the shard planner, which the engine and `reuse_linear`
import, import them in turn. `repro_torch` imports this package before any
other, so none of them meets it half-initialised."""

from repro_torch.core.similarity import (
    block_zero_mask,
    code_similarity,
    harvestable_similarity,
    row_code_similarity,
    similarity_breakdown,
)
from repro_torch.core.delta import DeltaEncoding, delta_encode, delta_encode_int8
from repro_torch.core.policy import (
    MODE_BASIC,
    MODE_REUSE,
    ReusePolicy,
    SiteTunables,
    layer_key,
    mode_name,
    split_layer_key,
)
from repro_torch.core.reuse_cache import (
    ReuseSiteSpec,
    cache_bytes,
    init_reuse_cache,
    init_site_cache,
    init_site_ctrl,
)
from repro_torch.core.reuse_linear import ReuseStats, reuse_linear
from repro_torch.core.engine import ReuseEngine

__all__ = [
    "DeltaEncoding",
    "MODE_BASIC",
    "MODE_REUSE",
    "ReuseEngine",
    "ReusePolicy",
    "ReuseSiteSpec",
    "ReuseStats",
    "SiteTunables",
    "block_zero_mask",
    "cache_bytes",
    "code_similarity",
    "delta_encode",
    "delta_encode_int8",
    "harvestable_similarity",
    "init_reuse_cache",
    "init_site_cache",
    "init_site_ctrl",
    "layer_key",
    "mode_name",
    "reuse_linear",
    "row_code_similarity",
    "similarity_breakdown",
    "split_layer_key",
]

