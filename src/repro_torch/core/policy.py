"""ReusePolicy — the kernelMode and execution-path decisions (paper Sec. IV).

A site runs in reuse mode iff  sim_ema >= threshold  and  M·K·N work >=
min_work, hysteretically: the signal must leave the current mode's band by
`hysteresis_margin`, and a flipped lane is frozen for `hysteresis_steps`
refresh passes. Decisions are host-side passes between decode steps.
`SiteTunables` are the per-site (and per-layer, "site@layer") overrides a
tuned table carries. Same constants and semantics as `repro.core.policy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np

from repro_torch.core.reuse_cache import ReuseSiteSpec, default_exec_path

DEFAULT_SIM_THRESHOLD = 0.20
DEFAULT_MIN_WORK_FLOPS = float(2**24)
DEFAULT_HYSTERESIS_MARGIN = 0.05
DEFAULT_HYSTERESIS_STEPS = 1

# Modeled break-even tile-skip rate above which the compacted (ragged) walk
# is preferred, and the budget headroom over measured occupancy. Modeled
# constants of the reference; not yet measured on the H100.
RAGGED_BREAK_EVEN_SKIP = 0.25
RAGGED_BUDGET_HEADROOM = 1.25

# Paths a tuned table may name. "compact" and "dense" are the reference's
# jnp-tier paths, which this package does not run yet (reuse_linear raises).
EXEC_PATHS = ("kernel", "ragged", "compact", "dense")

MODE_BASIC = 0
MODE_REUSE = 1


def mode_name(mode_id: int) -> str:
    return "reuse" if int(mode_id) > 0 else "basic"


def layer_key(site: str, layer: int) -> str:
    """Table key of one layer's tunables row ("site@layer")."""
    return f"{site}@{layer}"


def split_layer_key(key: str) -> tuple[str, int | None]:
    """Inverse of :func:`layer_key`: ("site", layer) or ("site", None)."""
    site, sep, layer = key.rpartition("@")
    if sep and layer.isdigit():
        return site, int(layer)
    return key, None


@dataclasses.dataclass(frozen=True)
class SiteTunables:
    """Per-site policy knobs; `block_k=None` keeps the registration default."""

    sim_threshold: float = DEFAULT_SIM_THRESHOLD
    min_work_flops: float = DEFAULT_MIN_WORK_FLOPS
    block_k: int | None = None
    hysteresis_margin: float = DEFAULT_HYSTERESIS_MARGIN
    hysteresis_steps: int = DEFAULT_HYSTERESIS_STEPS
    exec_path: str | None = None
    max_active_k: int | None = None

    def __post_init__(self) -> None:
        if self.exec_path is not None and self.exec_path not in EXEC_PATHS:
            raise ValueError(
                f"exec_path {self.exec_path!r} not in {EXEC_PATHS}")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SiteTunables":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class ReusePolicy:
    sim_threshold: float = DEFAULT_SIM_THRESHOLD
    min_work_flops: float = DEFAULT_MIN_WORK_FLOPS
    dataflow_output_bias: float = 1.0  # >1 prefers output-stationary
    hysteresis_margin: float = DEFAULT_HYSTERESIS_MARGIN
    hysteresis_steps: int = DEFAULT_HYSTERESIS_STEPS
    ragged_break_even_skip: float = RAGGED_BREAK_EVEN_SKIP
    site_tunables: dict[str, SiteTunables] = dataclasses.field(
        default_factory=dict
    )

    def resolve(self, site: str, layer: int | None = None) -> SiteTunables:
        """Tunables of one site: its per-layer row, else its site row, else
        the global defaults."""
        if layer is not None:
            t = self.site_tunables.get(layer_key(site, layer))
            if t is not None:
                return t
        t = self.site_tunables.get(site)
        if t is not None:
            return t
        return SiteTunables(
            sim_threshold=self.sim_threshold,
            min_work_flops=self.min_work_flops,
            hysteresis_margin=self.hysteresis_margin,
            hysteresis_steps=self.hysteresis_steps,
        )

    def decide_mode(
        self,
        spec: ReuseSiteSpec,
        sim_ema: float,
        *,
        current_mode: str | None = None,
    ) -> str:
        """kernelMode of one site from its site row. With `current_mode` the
        comparison is hysteretic: the signal must cross the threshold by
        `hysteresis_margin` before the decision leaves the current mode."""
        if spec.mode in ("reuse", "basic"):
            return spec.mode
        t = self.resolve(spec.name)
        work = 2.0 * spec.in_features * spec.out_features
        if work < t.min_work_flops:
            return "basic"
        threshold = t.sim_threshold
        if current_mode == "reuse":
            threshold -= t.hysteresis_margin
        elif current_mode == "basic":
            threshold += t.hysteresis_margin
        return "reuse" if sim_ema >= threshold else "basic"

    def decide_modes(
        self,
        spec: ReuseSiteSpec,
        sim_ema: np.ndarray,        # [L] per-layer mean similarity
        mode_id: np.ndarray,        # [L] current mode ids
        sim_threshold: np.ndarray,  # [L]
        min_work: np.ndarray,       # [L]
        *,
        hysteresis_margin: np.ndarray,         # [L]
        quarantine: np.ndarray | None = None,  # [L]
    ) -> np.ndarray:
        """Wanted mode ids [L], lane-wise; a quarantined lane is pinned basic."""
        if spec.mode in ("reuse", "basic"):
            pinned = MODE_REUSE if spec.mode == "reuse" else MODE_BASIC
            want = np.full_like(np.asarray(mode_id), pinned)
        else:
            work = 2.0 * spec.in_features * spec.out_features
            thr = np.where(
                mode_id > 0,
                sim_threshold - hysteresis_margin,
                sim_threshold + hysteresis_margin,
            )
            want = np.where(sim_ema >= thr, MODE_REUSE, MODE_BASIC)
            want = np.where(work < min_work, MODE_BASIC, want)
        if quarantine is not None:
            want = np.where(np.asarray(quarantine) > 0, MODE_BASIC, want)
        return np.asarray(want).astype(np.asarray(mode_id).dtype)

    def resolve_block_k(self, site: str, default: int) -> int:
        bk = self.resolve(site).block_k
        return default if bk is None else int(bk)

    def resolve_exec_path(self, site: str, default: str = "auto") -> str:
        p = self.resolve(site).exec_path
        return default if p is None else p

    def resolve_max_active_k(self, site: str) -> int | None:
        mak = self.resolve(site).max_active_k
        return None if mak is None else int(mak)

    def decide_exec_path(
        self, spec: ReuseSiteSpec, skip_rate: float, *, impl: str = "cuda"
    ) -> str:
        """Path of one site from its measured tile-skip rate: a tuned pin
        wins; above the break-even skip (and gk >= 2) the compacted tier,
        "ragged" on the kernel tiers and "compact" on "jnp"."""
        t = self.resolve(spec.name)
        if t.exec_path is not None:
            return t.exec_path
        gk = -(-spec.in_features // spec.block_k)
        if gk >= 2 and skip_rate >= self.ragged_break_even_skip:
            return "ragged" if impl != "jnp" else "compact"
        return default_exec_path(impl)

    @staticmethod
    def ragged_budget(gk: int, skip_rate: float) -> int:
        """k-extent budget: measured occupancy plus headroom, in [1, gk]."""
        occ = max(0.0, min(1.0, 1.0 - skip_rate))
        want = math.ceil(gk * occ * RAGGED_BUDGET_HEADROOM)
        return max(1, min(gk, want))

    def decide_dataflow(self, in_features: int, out_features: int) -> str:
        """Input-stationary only when the aspect ratio strongly favours
        holding inputs (in_features > 4·out_features)."""
        if in_features > self.dataflow_output_bias * 4 * out_features:
            return "input"
        return "output"
