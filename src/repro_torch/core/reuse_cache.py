"""ReuseCache — per-site state of the reuse engine (the ReuseSensor scratchpad).

Each reuse site (one linear op) owns a cache entry of tensors:

    prev_q    : int8  [M, K]  previous input, quantized codes
    prev_out  : f32   [M, N]  previous output
    scale     : f32   scalar  activation quant scale
    sim_ema   : f32   [M]     per-slot running code-similarity estimate
    steps     : i32   scalar  evaluations seen
    sensor    : dict          measured reuse-accounting counters
    ctrl      : dict          per-layer control block (init_site_ctrl)
    mode_host : numpy int8    host mirror of ctrl["mode_id"]

Sites inside the layer stack carry a leading [L] axis on every tensor leaf
(`ReuseEngine.init_cache` broadcasts), and the model hands layer l a view of
lane l. The reference branches on the device-resident mode id with
`lax.cond`; read eagerly, that lane would cost one device→host sync per site
per layer. Mode ids change only in host passes between steps (`set_mode`,
`refresh_modes`), so those passes write `mode_host` beside the device lane
and the dispatch reads the mirror.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ReuseSiteSpec:
    """Static description of one reuse site (the CRS parameter-table analogue)."""

    name: str
    in_features: int
    out_features: int
    block_m: int = 8
    block_k: int = 256
    block_n: int = 128
    mode: str = "auto"          # "reuse" | "basic" | "auto" (policy decides)
    dataflow: str = "output"    # "output" | "input" stationary
    # "kernel" | "ragged" | "compact" | "dense" | "auto" (default_exec_path)
    exec_path: str = "auto"
    max_active_k: int | None = None
    fixed_scale: float = 0.05


def default_exec_path(impl: str) -> str:
    """The path an "auto" site runs on: the masked block-skip kernel on the
    kernel tiers ("cuda", "torch"), the masked product on the reference's
    serve tier "jnp"."""
    return "kernel" if impl != "jnp" else "dense"


def kernel_impl(impl: str) -> str:
    """The kernel substrate (`ops.IMPLS`) an engine tier runs on: the
    reference's serve tier "jnp" launches the Hopper kernels, as "cuda"."""
    return "cuda" if impl == "jnp" else impl


def resolve_exec_path(spec: ReuseSiteSpec, impl: str) -> str:
    if spec.exec_path == "auto":
        return default_exec_path(impl)
    return spec.exec_path


def init_site_ctrl(
    spec: ReuseSiteSpec, tunables=None, *, device
) -> dict[str, torch.Tensor]:
    """Fresh control block for one site (one layer's worth). Leaf dtypes as
    the reference: int8 mode_id, int32 cooldown/quarantine, f32 the rest."""
    from repro_torch.core.policy import (
        DEFAULT_MIN_WORK_FLOPS,
        DEFAULT_SIM_THRESHOLD,
    )

    mode0 = 0 if spec.mode == "basic" else 1
    thr = tunables.sim_threshold if tunables is not None else DEFAULT_SIM_THRESHOLD
    mw = tunables.min_work_flops if tunables is not None else DEFAULT_MIN_WORK_FLOPS
    return {
        "mode_id": torch.tensor(mode0, dtype=torch.int8, device=device),
        "sim_threshold": torch.tensor(thr, dtype=torch.float32, device=device),
        "min_work": torch.tensor(mw, dtype=torch.float32, device=device),
        "cooldown": torch.zeros((), dtype=torch.int32, device=device),
        "occupancy": torch.ones((), dtype=torch.float32, device=device),
        "quarantine": torch.zeros((), dtype=torch.int32, device=device),
    }


def init_site_cache(
    spec: ReuseSiteSpec, batch: int, tunables=None, *, device
) -> dict:
    from repro_torch.sensor.counters import init_site_counters

    ctrl = init_site_ctrl(spec, tunables, device=device)
    return {
        "prev_q": torch.zeros((batch, spec.in_features), dtype=torch.int8,
                              device=device),
        "prev_out": torch.zeros((batch, spec.out_features),
                                dtype=torch.float32, device=device),
        "scale": torch.tensor(spec.fixed_scale, dtype=torch.float32,
                              device=device),
        "sim_ema": torch.zeros((batch,), dtype=torch.float32, device=device),
        "steps": torch.zeros((), dtype=torch.int32, device=device),
        "sensor": init_site_counters(batch, device=device),
        "ctrl": ctrl,
        "mode_host": np.asarray(ctrl["mode_id"].cpu().numpy()),
    }


def init_reuse_cache(specs: dict[str, ReuseSiteSpec], batch: int, *,
                     device="cuda") -> dict[str, dict]:
    """Cache tree for a whole model: {site_name: entry} (one layer's worth
    per site; the engine stacks its own along the layers)."""
    return {name: init_site_cache(spec, batch, device=device)
            for name, spec in specs.items()}


def map_tensors(fn, tree):
    """Apply `fn` to every tensor leaf of a nested dict (numpy leaves, such as
    the mode mirror, go through `fn` too when it accepts them)."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_bytes(cache: dict) -> int:
    """Total device footprint of a reuse cache's tensors."""
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        return t

    map_tensors(add, cache)
    return total
