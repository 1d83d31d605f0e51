"""The closed control loop on a model: the port's `Controller` driving the
port's measured decode, against the reference's on the reference's, on the
CPU (a file of its own: the reference's loop takes about a minute a model).

Reduced qwen3-32b and reduced rwkv6-7b (2 layers), batch 2, correlation
1.0, 26 steps with a dissimilarity burst at steps 19-22 — the reference's
acceptance scenario (`tests/test_control.py::
test_closed_loop_control_matches_tuned_baseline`): each package's
Controller runs every 2 steps with `min_window_steps=2`, from the default
policy. The port is given the reference's weights. The reference's runner
builds an impl="jnp" engine, whose controller fits the "compact" path the
port does not run; here it builds impl="pallas" (the compiled-XLA tier on
this host) through a monkeypatch, so both fit "ragged". Journals equal row
for row (`to_dicts()` without `ts`); greedy tokens equal; final specs,
policy tables and mode mirrors equal (the mirrors to the reference's ctrl
`mode_id`); counters, codes and lanes bitwise (`assert_caches_match`).
And the reference test's properties hold on the port.
"""

import dataclasses

import numpy as np
import pytest

import repro.control as jctl
from repro.sensor import runner as jrunner
from repro_torch import control as tctl
from repro_torch.sensor import runner as trunner
from test_torch_engine import assert_caches_match
from test_torch_measured import reference_params

STEPS, BATCH, BURST = 26, 2, (19, 22)


def closed_loop(runner, ctl_pkg, arch, monkeypatch, **kw):
    """One controlled run; returns (controller, MeasuredDecode, sensor
    reports at steps 10 and 18, the greedy tokens of every step)."""
    ctl = ctl_pkg.Controller(ctl_pkg.ControlConfig(min_window_steps=2))
    reports, tokens = {}, []
    greedy = runner.greedy_sample

    def recording_greedy(logits):
        out = greedy(logits)
        tokens.append(np.asarray(out).copy())
        return out

    def on_step(i, engine, cache):
        if i % 2 == 0:
            ctl.step(engine, cache, step=i)
        if i in (10, 18):  # the converged window's bounds
            reports[i] = engine.sensor_report(cache)

    monkeypatch.setattr(runner, "greedy_sample", recording_greedy)
    md = runner.run_measured_decode(arch, steps=STEPS, batch=BATCH,
                                    correlation=1.0, burst=BURST,
                                    on_step=on_step, **kw)
    monkeypatch.setattr(runner, "greedy_sample", greedy)
    return ctl, md, reports, tokens


def rows(ctl):
    return [{k: v for k, v in row.items() if k != "ts"}
            for rep in ctl.reports for row in rep.to_dicts()]


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_closed_loop_matches_reference(arch, monkeypatch):
    build = jrunner.build_reuse_engine
    monkeypatch.setattr(
        jrunner, "build_reuse_engine",
        lambda cfg, *, impl="jnp", policy=None: build(cfg, impl="pallas",
                                                      policy=policy))
    jc, jmd, _, jtok = closed_loop(jrunner, jctl, arch, monkeypatch)
    tc, tmd, trep, ttok = closed_loop(trunner, tctl, arch, monkeypatch,
                                      device="cpu",
                                      params=reference_params(arch))

    trows = rows(tc)
    assert trows == rows(jc)
    assert len(ttok) == len(jtok) == STEPS
    for a, b in zip(ttok, jtok):
        np.testing.assert_array_equal(a, b)
    te, je = tmd.engine, jmd.engine
    assert {n: dataclasses.asdict(s) for n, s in te.sites.items()} == \
        {n: dataclasses.asdict(s) for n, s in je.sites.items()}
    assert {k: t.to_dict() for k, t in te.policy.site_tunables.items()} == \
        {k: t.to_dict() for k, t in je.policy.site_tunables.items()}
    for name in te.sites:
        np.testing.assert_array_equal(te.entry_mode_ids(tmd.cache[name]),
                                      je.entry_mode_ids(jmd.cache[name]))
    assert_caches_match(jmd.cache, tmd.cache)
    # both engines run the kernel tier, so the sensor rows are equal whole
    assert tmd.report.to_dicts() == jmd.report.to_dicts()

    # the reference test's properties, on the port
    modes = te.mode_summary(tmd.cache)
    assert any(m in ("reuse", "mixed") for m in modes.values())
    assert any(s.exec_path == "ragged" for s in te.sites.values())
    w0, w1 = trep[10], trep[18]
    win_mac = (w1.model["skipped_macs"] - w0.model["skipped_macs"]) / max(
        w1.model["total_macs"] - w0.model["total_macs"], 1e-9)
    assert win_mac > 0.5
    assert tmd.report.model["overflow_fallbacks"] > 0
    budget = [r for r in trows if r.get("decision_kind") == "budget"]
    assert any("overflow_fallbacks" in r["reason"] for r in budget)
    # and the journal replays
    assert tctl.replay_rows(trows).ok
