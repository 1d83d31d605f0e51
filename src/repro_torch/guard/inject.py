"""Deterministic fault injector — named, replayable failure scenarios.

The port of `repro.guard.inject`. Chaos with a seed: every scenario is a
pure function of (scenario params, seed, step), so a failing run replays
with the same flags and the same fault lands at the same step. The injector
hooks the REAL seams the serving plane exposes — the post-update reuse
cache, the ctrl block, the retirement telemetry callback, the
decision-journal file, the checkpoint directory, and the step clock — so a
passing chaos test certifies the production wiring, not a test double.

The cache scenarios write into the live tensors (the compiled step's CUDA
graphs read the tensors they were captured on) and return the cache, so the
hook chains as the reference's does. `ctrl-garbage` writes mode_id = 7 to
the device lane and to its host mirror `mode_host`: the port dispatches on
the mirror, and both packages then run reuse (mode id > 0), as the
reference does on the device lane. The mirror moves the decode key, so the
step after that injection may capture.

Scenarios (see SCENARIOS for tunable parameters):

    poison-nan       NaN written into a prev_out cache lane (stale-product
                     corruption — the exact hazard computation reuse adds)
    poison-sim       NaN written into a sim_ema lane (drives mode decisions)
    ctrl-garbage     out-of-range ctrl lanes: mode_id=7, cooldown=-3
    poison-counters  skipped_tiles bumped without work — breaks the
                     skipped+computed == steps·gm·gk conservation invariant
    lying-telemetry  retirement telemetry reports a non-finite / out-of-range
                     hit_rate (attacks the admission predictor's EMA)
    torn-journal     the decision journal's final row is half-written
                     (simulated crash mid-append)
    corrupt-ckpt     bytes flipped mid-file in the newest checkpoint's host
                     payload (bitrot / torn write behind a COMPLETE marker)
    stall            the step clock stalls for `seconds` (straggler host)

Usage::

    inj = FaultInjector.from_spec("poison-nan:at_step=12,site=mlp_in")
    cache = inj.on_cache_update(cache, step)     # serve loop, post-decode
    t = inj.on_telemetry(t, step)                # retirement path
    inj.maybe_stall(step)                        # inside the timed region
    inj.tear_journal(path); inj.corrupt_checkpoint(ckpt_dir)   # at exit

Every fault that actually fired is appended to `.fired` for assertions.

On a model-sharded engine (`bind(engine)`, as the serve does) a cache
scenario's index is one of the one-device layout, whose shard axis sits
inside the layer axis; `shard=S` in the spec aims it at shard S's lane
(without it, the index reaches whichever lanes it covers). One shard a
card, each rank writes the part of that index its own lane holds, so the
fault lands where the one-device engine's lands (the host mirror of the
mode lanes, which holds every shard's lane on every rank, is written on
every rank); every rank records it as fired.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from repro_torch.dist.shard import shard_axis_of

SCENARIOS: dict[str, dict[str, Any]] = {
    "poison-nan": {
        "at_step": 12,
        "desc": "NaN into a prev_out cache lane (stale-product corruption)",
    },
    "poison-sim": {
        "at_step": 12,
        "desc": "NaN into a sim_ema lane (poisons mode decisions)",
    },
    "ctrl-garbage": {
        "at_step": 12,
        "desc": "out-of-range ctrl lanes (mode_id=7, cooldown=-3)",
    },
    "poison-counters": {
        "at_step": 12,
        "bump": 7,
        "desc": "skipped_tiles bumped without work (breaks conservation)",
    },
    "lying-telemetry": {
        "at_step": 0,
        "value": float("nan"),
        "desc": "retirement telemetry reports a bogus hit_rate",
    },
    "torn-journal": {
        "desc": "decision journal's final row half-written (crash mid-append)",
    },
    "corrupt-ckpt": {
        "desc": "bytes flipped mid-file in the newest checkpoint host payload",
    },
    "stall": {
        "at_step": 12,
        "seconds": 0.25,
        "desc": "step clock stalls (straggler host)",
    },
}

_CACHE_SCENARIOS = {
    "poison-nan", "poison-sim", "ctrl-garbage", "poison-counters",
}


def _coerce(raw: str) -> Any:
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


class FaultInjector:
    """One named scenario, armed with concrete parameters. Hooks that don't
    belong to the scenario are no-ops, so serve can wire every hook
    unconditionally."""

    def __init__(self, scenario: str, *, site: str | None = None,
                 layer: int | None = None, seed: int = 0,
                 shard: int | None = None, **params: Any):
        if scenario not in SCENARIOS:
            raise ValueError(
                f"unknown fault scenario {scenario!r}; "
                f"have {sorted(SCENARIOS)}")
        defaults = {k: v for k, v in SCENARIOS[scenario].items()
                    if k != "desc"}
        unknown = set(params) - set(defaults)
        if unknown:
            raise ValueError(
                f"scenario {scenario!r} takes {sorted(defaults)}, "
                f"got unknown {sorted(unknown)}")
        self.scenario = scenario
        self.site = site
        self.layer = layer
        self.seed = seed
        self.shard = shard
        self.engine = None
        self.params = {**defaults, **params}
        self.fired: list[dict[str, Any]] = []

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse ``name`` or ``name:key=val,key=val`` (the --inject flag)."""
        name, _, rest = spec.partition(":")
        kwargs: dict[str, Any] = {}
        if rest:
            for part in rest.split(","):
                key, _, raw = part.partition("=")
                if not _ or not key:
                    raise ValueError(
                        f"bad injector spec segment {part!r} in {spec!r}")
                kwargs[key.strip()] = _coerce(raw.strip())
        site = kwargs.pop("site", None)
        layer = kwargs.pop("layer", None)
        seed = kwargs.pop("seed", 0)
        shard = kwargs.pop("shard", None)
        return cls(name.strip(), site=site, layer=layer, seed=seed,
                   shard=shard, **kwargs)

    def bind(self, engine) -> "FaultInjector":
        """Read the engine's layer stacking, shard plan and placement when
        aiming a cache scenario (see the module docstring)."""
        self.engine = engine
        return self

    # ------------------------------------------------------------------ hooks
    def _pick(self, cache: dict[str, Any]) -> tuple[str, int | None]:
        site = self.site if self.site is not None else sorted(cache)[0]
        if site not in cache:
            raise KeyError(f"injector target site {site!r} not in cache")
        if self.engine is not None:
            stacked = self.engine.stacking.get(site, 0) > 0
        else:
            stacked = cache[site]["prev_q"].ndim == 3
        layer = self.layer
        if stacked and layer is None:
            layer = 0
        if not stacked:
            layer = None
        return site, layer

    def _lane(self, layer: int | None) -> tuple:
        return () if layer is None else (layer,)

    def _aim(self, site: str, idx: tuple) -> tuple:
        """`idx`, an index of the one-device layout, with `shard=` put on
        the shard axis."""
        eng = self.engine
        if eng is None or not eng.shards.get(site) or self.shard is None:
            return idx
        ax = shard_axis_of(eng.stacking.get(site, 0))
        if len(idx) >= ax:
            idx = idx[:ax] + (int(self.shard),) + idx[ax:]
        return idx

    def _here(self, site: str, idx: tuple) -> tuple | None:
        """`_aim(site, idx)` as an index of this process's cache; None when
        it lies wholly in another rank's lane."""
        idx = self._aim(site, idx)
        eng = self.engine
        if eng is None or not eng.shards.get(site) or eng.placement is None:
            return idx
        ax = shard_axis_of(eng.stacking.get(site, 0))
        if len(idx) <= ax:
            return idx
        if idx[ax] != eng.placement.shard:
            return None
        return idx[:ax] + (0,) + idx[ax + 1:]

    def on_cache_update(self, cache: dict[str, Any], step: int,
                        ) -> dict[str, Any]:
        """Post-decode cache hook: writes one lane at `at_step`, in place."""
        if self.scenario not in _CACHE_SCENARIOS:
            return cache
        if step != self.params["at_step"]:
            return cache
        site, layer = self._pick(cache)
        lane = self._lane(layer)
        entry = cache[site]
        if self.scenario == "poison-nan":
            at = self._here(site, lane + (0, 0))
            if at is not None:
                entry["prev_out"][at] = float("nan")
            detail = "prev_out[...,0,0] = NaN"
        elif self.scenario == "poison-sim":
            at = self._here(site, lane + (0,))
            if at is not None:
                entry["sim_ema"][at] = float("nan")
            detail = "sim_ema[...,0] = NaN"
        elif self.scenario == "ctrl-garbage":
            ctrl = entry["ctrl"]
            at = self._here(site, lane)
            if at is not None:
                ctrl["mode_id"][at] = 7
                ctrl["cooldown"][at] = -3
            # the host mirror holds every shard's lane on every rank
            entry["mode_host"][self._aim(site, lane)] = 7
            detail = "ctrl mode_id=7, cooldown=-3"
        else:  # poison-counters
            bump = int(self.params["bump"])
            at = self._here(site, lane)
            if at is not None:
                entry["sensor"]["skipped_tiles"][at] += bump
            detail = f"skipped_tiles += {bump} without work"
        self.fired.append({"scenario": self.scenario, "step": step,
                           "site": site, "layer": layer, "detail": detail})
        return cache

    def on_telemetry(self, telemetry: dict[str, Any], step: int,
                     ) -> dict[str, Any]:
        """Retirement-telemetry hook: first retirement at/after `at_step`
        reports a bogus hit_rate."""
        if self.scenario != "lying-telemetry" or self.fired:
            return telemetry
        if step < self.params["at_step"]:
            return telemetry
        value = float(self.params["value"])
        self.fired.append({"scenario": self.scenario, "step": step,
                           "detail": f"hit_rate -> {value}"})
        return dict(telemetry, hit_rate=value)

    def maybe_stall(self, step: int) -> None:
        """Step-clock hook: call inside the timed region of the decode step."""
        if self.scenario != "stall" or step != self.params["at_step"]:
            return
        seconds = float(self.params["seconds"])
        time.sleep(seconds)
        self.fired.append({"scenario": self.scenario, "step": step,
                           "detail": f"slept {seconds}s"})

    # -------------------------------------------------------- at-rest targets
    def tear_journal(self, path) -> None:
        """Truncate the journal mid-way through its final row (simulated
        crash between write and flush)."""
        if self.scenario != "torn-journal":
            return
        import os
        data = open(path, "rb").read()
        body = data.rstrip(b"\n")
        last_nl = body.rfind(b"\n")
        last_len = len(body) - (last_nl + 1)
        if last_len < 2:
            return
        cut = len(body) - last_len // 2
        with open(path, "wb") as f:
            f.write(data[:cut])
            f.flush()
            os.fsync(f.fileno())
        self.fired.append({
            "scenario": self.scenario, "step": -1,
            "detail": f"truncated {path} to {cut}/{len(data)} bytes "
                      f"(final row torn)"})

    def corrupt_checkpoint(self, directory) -> None:
        """Flip bytes mid-file in the newest COMPLETE checkpoint's first host
        payload — bitrot behind a COMPLETE marker."""
        if self.scenario != "corrupt-ckpt":
            return
        from pathlib import Path
        root = Path(directory)
        markers = sorted(root.glob("step_*.COMPLETE"), reverse=True)
        if not markers:
            return
        step_dir = root / markers[0].name[: -len(".COMPLETE")]
        hosts = sorted(step_dir.glob("host_*.npz"))
        if not hosts:
            return
        target = hosts[0]
        data = bytearray(target.read_bytes())
        rng = np.random.default_rng(self.seed)
        mid = len(data) // 2
        span = min(64, max(1, len(data) - mid))
        data[mid:mid + span] = rng.integers(
            0, 256, size=span, dtype=np.uint8).tobytes()
        target.write_bytes(bytes(data))
        self.fired.append({
            "scenario": self.scenario, "step": -1,
            "detail": f"flipped {span} bytes mid-file in {target}"})
