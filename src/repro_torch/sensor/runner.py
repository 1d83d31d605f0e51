"""Measured-decode harness: run real decode steps, return the SensorReport.

The port of `repro.sensor.runner`: a model decodes a correlated token stream
with the reuse engine threaded, and the report comes from the live counters
the kernels' tile masks produced — not from any assumed similarity table.

The correlated stream: with probability `correlation` the next token
re-anchors to a fixed token, otherwise it follows the model's own greedy
output. High correlation ⇒ consecutive activations quantize to similar
codes ⇒ measurable tile skips, the operating regime the paper measures
(Table I). The stream draws from `numpy.random.default_rng(seed)` in the
reference's order (the anchor; the pre-loop burst draw; per step the burst
draw or the `keep` draw), so equal logits give the reference's tokens.

Each step is the serve's step: `serve/compiled_step.CompiledStep.decode`,
a CUDA graph per decode key on the card (captured at the first step of a
key, replayed after), the step function run directly on the CPU or with
`graphs=False`. A policy refresh or an `on_step` hook that changes a mode or
a spec changes the key, so the next step captures or replays its variant.

Kept out of ``repro_torch.sensor.__init__``: importing it pulls in the
serving stack, which imports the sensor package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import init_params
from repro_torch.serve.compiled_step import CompiledStep
from repro_torch.serve.serve_step import (
    build_reuse_engine,
    greedy_sample,
    init_serve_state,
)

# The measured operating points: (arch, stream correlation), the
# reference's table.
MEASURED_OPERATING_POINTS = [
    ("qwen3-32b", 0.95),
    ("mixtral-8x7b", 0.9),
    ("rwkv6-7b", 0.95),
]


@dataclasses.dataclass
class MeasuredDecode:
    arch: str
    steps: int
    batch: int
    engine: object
    cache: dict
    report: object          # SensorReport
    step: object = None     # the CompiledStep: decode state, variants

    @property
    def skip_fractions(self):
        from repro_torch.sensor.cost_model import measured_skip_fractions

        return measured_skip_fractions(self.report)


def run_measured_decode(
    arch: str,
    *,
    steps: int = 10,
    batch: int = 2,
    cache_len: int = 64,
    correlation: float = 0.9,
    seed: int = 0,
    reduced: bool = True,
    refresh_policy: bool = False,
    policy=None,
    on_step=None,
    burst: tuple[int, int] | None = None,
    device="cuda",
    params=None,
    cfg=None,
    graphs: bool | None = None,
    impl: str | None = None,
) -> MeasuredDecode:
    """Decode `steps` tokens on a (reduced) arch and harvest sensor counters.

    refresh_policy=True re-runs the host-side mode policy between steps, so
    low-similarity sites demote to basic mode mid-run; False pins the
    registration-time modes, which keeps every site on the reuse path — the
    right setting when the point is to measure skip rates.

    `policy` (a ReusePolicy, e.g. from repro_torch.tune.load_tuned_policy)
    replaces the default global-constant policy.

    `on_step(step_idx, engine, reuse_cache)` runs host-side after each decode
    step (1-based); it may change the engine's policy, specs and modes and
    the cache's counters in place.

    `burst=(a, b)` feeds uniform-random tokens for steps a..b (1-based,
    inclusive) instead of the correlated stream.

    Beyond the reference: `device` (default the card; CPU tensors run the
    plain versions, impl "torch"; without a card "cuda" raises), `params`
    (weights to use instead of `init_params(cfg, seed)`, e.g. the
    reference's through `params_from_numpy`), `cfg` (a config in place of
    `ARCHS[arch]`, e.g. one cut in depth; `reduced` is then not applied) and
    `graphs` (CUDA graphs; default: on the card) and `impl` (the engine's
    tier; default "cuda" on the card and "torch" on the CPU; "jnp" is the
    reference runner's own, whose "auto" sites run "dense" and whose
    promotions go to "compact").
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_measured_decode: device cuda but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain PyTorch versions")
    if cfg is None:
        cfg = ARCHS[arch]
        if reduced:
            cfg = cfg.reduced()
    if impl is None:
        impl = "cuda" if device.type == "cuda" else "torch"
    rng = np.random.default_rng(seed)
    if params is None:
        params = init_params(cfg, seed, device=device)
    engine = build_reuse_engine(cfg, impl=impl, policy=policy)
    rcache = engine.init_cache(batch, device=device)
    state = init_serve_state(cfg, batch, cache_len, device=device)
    step = CompiledStep(params, cfg, state, batch=batch, engine=engine,
                        rcache=rcache,
                        graphs=device.type == "cuda" if graphs is None
                        else graphs)

    anchor = rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32)
    tok = anchor
    if burst is not None and burst[0] <= 1 <= burst[1]:
        # a burst covering step 1 must randomize the pre-loop token too
        tok = rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32)
    for i in range(steps):
        # the greedy tokens are read before the hooks: the logits live in
        # the step's buffer only until its next call
        nxt = greedy_sample(step.decode(tok)).cpu().numpy()[:, :1]
        if refresh_policy:
            engine.refresh_modes(rcache)
        if on_step is not None:
            on_step(i + 1, engine, rcache)
        if burst is not None and burst[0] <= i + 2 <= burst[1]:
            # the NEXT step (i+2, 1-based) decodes inside the burst
            tok = rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32)
            continue
        keep = rng.random((batch, 1)) < correlation
        tok = np.where(keep, anchor, nxt).astype(np.int32)

    return MeasuredDecode(
        arch=arch,
        steps=steps,
        batch=batch,
        engine=engine,
        cache=rcache,
        report=engine.sensor_report(rcache),
        step=step,
    )
