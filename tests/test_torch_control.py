"""The port's online control plane (`repro_torch.control`) against the
reference's (`repro.control`), on the CPU.

The same inputs, made with numpy from a seed, go through both packages:
the admission predictor and the batcher's placement hooks (equal
predictions, placements and stats), the retuner's pure functions (equal
dataclasses; the port's packed counter snapshot equal to the reference's
per-counter reads, bitwise), and the reference's two adversarial
engine-level scenarios driven by each package's own `Controller` — the
reference engine at impl="pallas" (the compiled-XLA tier on this host),
the port's at impl="torch" — whose journals must be equal row for row
(`to_dicts()` without `ts`) and whose final specs, policy tables, ctrl
lanes and counters must be bitwise equal. Journals cross-load both ways,
the serve CLI runs with the controller, and the controller never rebinds a
cache tensor (the compiled step's CUDA graphs read the tensors they were
captured on).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.control as jctl
from repro.core import ReuseEngine as JEngine
from repro.core import ReusePolicy as JPolicy
from repro.core import SiteTunables as JTunables
from repro.core.reuse_cache import ReuseSiteSpec as JSpec
from repro.serve import scheduler as jsched
from repro.tune.harvest import FitConfig as JFit
from repro.tune.trace import SiteTraceRecord as JRecord
from repro_torch import control as tctl
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.core.reuse_cache import ReuseSiteSpec
from repro_torch.launch import serve as tserve_cli
from repro_torch.sensor.runner import run_measured_decode
from repro_torch.serve import scheduler as tsched
from repro_torch.tune.harvest import FitConfig
from repro_torch.tune.trace import SiteTraceRecord
from test_torch_engine import assert_caches_match

PKGS = {
    "ref": dict(engine=JEngine, policy=JPolicy, tunables=JTunables,
                fit=JFit, ctl=jctl, impl="pallas"),
    "port": dict(engine=ReuseEngine, policy=ReusePolicy,
                 tunables=SiteTunables, fit=FitConfig, ctl=tctl,
                 impl="torch"),
}


def journal_rows(ctl):
    """Every interval's journal rows, without the wall-clock `ts`."""
    return [{k: v for k, v in row.items() if k != "ts"}
            for rep in ctl.reports for row in rep.to_dicts()]


# ------------------------------------------------------ 1. admission predictor

def _req(sched, rid, slot, session=None, hit=None, steps=5):
    r = sched.Request(rid=rid, prompt=np.zeros(4, np.int32), session=session)
    r.slot = slot
    if hit is not None:
        r.telemetry = {"slot": slot, "steps": steps, "hit_rate": hit,
                       "n_sites": 1}
    return r


def test_admission_predictor_matches_reference():
    """One sequence of placements, retirements (sessions, rid-keyed
    one-shots, zero-step and forged telemetry, eviction at max_sessions)
    and slot resets into both predictors: predict, slot_affinity and stats
    equal after every operation."""
    rng = np.random.default_rng(0)
    preds = {"ref": jctl.AdmissionPredictor(max_sessions=3),
             "port": tctl.AdmissionPredictor(max_sessions=3)}
    scheds = {"ref": jsched, "port": tsched}
    probe_sessions = ["s0", "s1", "s2", "never", None]
    for i in range(80):
        op = rng.integers(0, 4)
        slot = int(rng.integers(0, 4))
        session = [f"s{rng.integers(0, 5)}", None][int(rng.random() < 0.2)]
        hit = [float(rng.random()), float("nan"), 1.7, -0.2][
            int(rng.choice(4, p=[0.7, 0.1, 0.1, 0.1]))]
        steps = int(rng.integers(0, 4))
        for name, pred in preds.items():
            req = _req(scheds[name], i, slot, session, hit, steps)
            if op == 0:
                pred.on_placed(req)
            elif op == 1:
                pred.observe_retirement(req)
            elif op == 2:
                scheds[name].reset_slot(None, slot, admission=pred)
            else:
                pred.on_placed(req)
                pred.observe_retirement(req)
        for probe in probe_sessions:
            got = [p.predict(_req(scheds[n], 100 + i, 0, probe))
                   for n, p in preds.items()]
            assert got[0] == got[1]
        for s in range(5):
            assert (preds["ref"].slot_affinity(s)
                    == preds["port"].slot_affinity(s))
        assert preds["ref"].stats() == preds["port"].stats()
        assert preds["ref"].slot_session == preds["port"].slot_session
        assert preds["ref"].sessions == preds["port"].sessions
    assert preds["port"].rejected_observations > 0
    assert preds["port"].observations > 3


# ----------------------------------------------------------------- 2. batcher

def _run_batcher(name):
    """Six requests of two sessions through a batcher of 3 slots with stub
    prefill/decode functions and the predictor's hooks. Returns (rid →
    slot placements, stats, predictor slot state after each reset)."""
    sched = {"ref": jsched, "port": tsched}[name]
    pred = PKGS[name]["ctl"].AdmissionPredictor()
    resets = []

    def telemetry_fn(slot):
        return {"slot": slot, "steps": 3, "hit_rate": 0.1 + 0.2 * slot,
                "n_sites": 1}

    def on_retire(req):
        pred.observe_retirement(req)
        sched.reset_slot(None, req.slot, admission=pred)
        resets.append((req.rid, dict(pred.slot_session),
                       dict(pred.lane_character), pred.stats()))

    b = sched.ContinuousBatcher(
        batch_slots=3, prefill_fn=lambda prompt, slot: 1,
        decode_fn=lambda toks: toks + 1, max_steps=100,
        telemetry_fn=telemetry_fn, on_retire=on_retire,
        slot_sim_fn=pred.slot_affinity, predict_sim_fn=pred.predict,
        on_place=pred.on_placed)
    for i in range(6):
        b.submit(sched.Request(rid=i, prompt=np.zeros(4, np.int32),
                               max_new_tokens=2 + i % 3,
                               session=f"sess-{i % 2}"))
    done = b.run()
    return {r.rid: r.slot for r in done}, b.stats, resets


def test_batcher_affinity_and_admission_hooks_match_reference():
    jplace, jstats, jresets = _run_batcher("ref")
    tplace, tstats, tresets = _run_batcher("port")
    assert tplace == jplace
    assert tstats == jstats
    assert tresets == jresets
    assert tstats["affinity_placements"] > 0
    assert len(tresets) == 6


def test_reset_slot_clears_admission_state_with_and_without_cache():
    engine = ReuseEngine(impl="torch")
    engine.register("s", 64, 32, block_m=2, block_k=32)
    cache = engine.init_cache(4, device="cpu")
    cache["s"]["sensor"]["slot_hit_sum"].fill_(1.0)
    pred = tctl.AdmissionPredictor()
    pred.on_placed(_req(tsched, 0, slot=2, session="X"))
    pred.on_placed(_req(tsched, 1, slot=1, session="Y"))
    assert tsched.reset_slot(cache, 2, admission=pred) is cache
    assert float(cache["s"]["sensor"]["slot_hit_sum"][2]) == 0.0
    assert float(cache["s"]["sensor"]["slot_hit_sum"][0]) == 1.0
    assert tsched.reset_slot(None, 1, admission=pred) is None
    assert pred.slot_session == {}


# --------------------------------------------------------- 3. pure functions

def _record(cls, **kw):
    base = dict(site="s", mode="reuse", steps=8, batch=2, in_features=256,
                out_features=64, block_m=2, block_k=64, block_n=128,
                tile_skip_rate=0.5, mac_skip_rate=0.5,
                weight_byte_skip_rate=0.5, hit_rate=0.6, mode_transitions=0,
                suppressed_flips=0, total_weight_bytes=1e6, total_macs=1e6,
                exec_path="ragged", grid_steps=10.0, grid_step_skip_rate=0.5,
                overflow_fallbacks=0)
    base.update(kw)
    return cls(**base)


def test_bounded_tunables_match_reference():
    rng = np.random.default_rng(1)
    paths = [None, "ragged", "kernel", "compact"]
    for _ in range(200):
        cur = dict(sim_threshold=float(rng.random()),
                   min_work_flops=float(10 ** rng.uniform(2, 9)),
                   block_k=int(rng.choice([64, 128, 256, 512])),
                   hysteresis_margin=0.05, hysteresis_steps=1,
                   exec_path=paths[rng.integers(0, 4)],
                   max_active_k=int(rng.integers(1, 9)))
        tgt = dict(sim_threshold=float(rng.random()),
                   min_work_flops=float(10 ** rng.uniform(2, 9)),
                   block_k=[None, 64, 128, 256, 512][rng.integers(0, 5)],
                   hysteresis_margin=float(rng.choice([0.05, 0.1])),
                   hysteresis_steps=int(rng.integers(1, 3)),
                   exec_path=paths[rng.integers(0, 4)],
                   max_active_k=[None, 2, 4][rng.integers(0, 3)])
        kw = dict(current_block_k=int(cur["block_k"]),
                  max_threshold_step=float(rng.choice([0.05, 0.1])),
                  max_min_work_raise=float(rng.choice([2.0, 8.0])))
        jout, jr = jctl.bounded_tunables(JTunables(**cur), JTunables(**tgt),
                                         **kw)
        tout, tr = tctl.bounded_tunables(SiteTunables(**cur),
                                         SiteTunables(**tgt), **kw)
        assert tout.to_dict() == jout.to_dict() and tr == jr


def test_adapt_budget_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(200):
        spec = dict(name="s", in_features=int(rng.choice([256, 1024])),
                    out_features=64, block_m=2,
                    block_k=int(rng.choice([64, 128])),
                    exec_path=["ragged", "compact", "kernel", "auto"][
                        rng.integers(0, 4)],
                    max_active_k=[None, 1, 2, 3, 8][rng.integers(0, 5)])
        rec = dict(steps=int(rng.integers(1, 9)),
                   block_k=int(rng.choice([64, 128])),
                   overflow_fallbacks=int(rng.integers(0, 3)),
                   tile_skip_rate=float(rng.random()))
        kw = dict(n_layers=int(rng.integers(1, 4)),
                  widen_fallback_rate=float(rng.choice([0.0, 0.1, 0.5])))
        got = tctl.adapt_budget(ReuseSiteSpec(**spec),
                                _record(SiteTraceRecord, **rec), **kw)
        want = jctl.adapt_budget(JSpec(**spec), _record(JRecord, **rec), **kw)
        assert got == want


def _fill_counters(jcache, tcache, rng, scale):
    """The same random counters into both caches (int32 and f32 leaves,
    stacked and unstacked), the reference's functionally."""
    for name in tcache:
        sensor = tcache[name]["sensor"]
        jsensor = dict(jcache[name]["sensor"])
        for key, t in sensor.items():
            if t.dtype == torch.int32:
                v = rng.integers(0, scale, size=tuple(t.shape)).astype(
                    np.int32)
            else:
                v = (rng.random(size=tuple(t.shape)) * scale).astype(
                    np.float32)
            v = np.asarray(v)
            t.copy_(torch.from_numpy(v))
            jsensor[key] = jnp.asarray(v)
        steps = np.asarray(rng.integers(0, scale, size=tuple(
            tcache[name]["steps"].shape)).astype(np.int32))
        tcache[name]["steps"].copy_(torch.from_numpy(steps))
        jcache[name] = dict(jcache[name], sensor=jsensor,
                            steps=jnp.asarray(steps))


def _assert_snap_equal(got, want):
    assert set(got) == set(want)
    for key, v in want.items():
        if key == "layers":
            _assert_snap_equal(got[key], v)
        elif isinstance(v, np.ndarray):
            assert got[key].dtype == v.dtype
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        else:
            assert type(got[key]) is type(v) and got[key] == v, key


def test_snapshot_and_windows_match_reference():
    """snapshot_entry (and the packed snapshot_cache) of a port cache equals
    the reference's on the same counters, bitwise; window_record and
    window_layer_records on two such snapshots give equal records."""
    rng = np.random.default_rng(3)
    engines = {}
    for name, pkg in PKGS.items():
        eng = pkg["engine"](impl=pkg["impl"])
        eng.register("stacked", 256, 128, n_layers=3, block_m=2, block_k=64)
        eng.register("flat", 320, 64, block_m=2, block_k=64)
        engines[name] = eng
    jc = engines["ref"].init_cache(4)
    tc = engines["port"].init_cache(4, device="cpu")
    snaps = []
    for scale in (50, 5000):
        _fill_counters(jc, tc, rng, scale)
        packed = tctl.retune.snapshot_cache(tc)
        pair = {}
        for name in tc:
            want = jctl.snapshot_entry(jc[name])
            _assert_snap_equal(tctl.snapshot_entry(tc[name]), want)
            _assert_snap_equal(packed[name], want)
            pair[name] = (packed[name], want)
        snaps.append(pair)
    for name in tc:
        (tprev, jprev), (tcur, jcur) = snaps[0][name], snaps[1][name]
        tspec, jspec = (engines[p].sites[name] for p in ("port", "ref"))
        trec = tctl.window_record(name, tspec, "reuse", "kernel", tprev, tcur)
        jrec = jctl.window_record(name, jspec, "reuse", "kernel", jprev, jcur)
        assert dataclasses.asdict(trec) == dataclasses.asdict(jrec)
        modes = ["reuse", "basic", "reuse"]
        tl = tctl.window_layer_records(name, tspec, modes, "ragged", tprev,
                                       tcur)
        jl = jctl.window_layer_records(name, jspec, modes, "ragged", jprev,
                                       jcur)
        assert {k: dataclasses.asdict(v) for k, v in tl.items()} == \
            {k: dataclasses.asdict(v) for k, v in jl.items()}
        assert len(tl) == (3 if name == "stacked" else 0)


def test_window_hit_rate_counts_lanes_within_f32_rounding():
    """A lane whose every evaluation matched at K = 5120 accumulates its
    hit sum in f32 (one FMA of K·f32(1/K) a step) and can close a 4-step
    window an ulp past 4. The reference drops that lane — with both lanes
    dropped its window reads hit 0 and the retuner demotes the lane that
    reuses most — where the port counts it at rate 1. A lane reset
    mid-window (gone backwards) or far past its steps drops out in both."""
    from repro.control.retune import _window_hit_rate as jrate
    from repro_torch.control.retune import _window_hit_rate as trate
    from repro_torch.core.similarity import fma_f32

    acc = torch.tensor([0.5093262, 0.123], dtype=torch.float32)
    sums = [acc.double().numpy()]
    for _ in range(5):
        acc = fma_f32(torch.full((2,), 5120.0), 1.0 / 5120, acc)
        sums.append(acc.double().numpy())
    d_hit, d_ss = sums[5] - sums[1], np.full(2, 4.0)
    assert (d_hit > d_ss).all()  # both lanes an ulp or more past 4 steps
    assert jrate(d_hit, d_ss) == 0.0
    assert trate(d_hit, d_ss, sums[5]) == 1.0
    # one such lane beside one at half the steps: the reference reads 0.5
    mixed = np.array([d_hit[0], 2.0])
    assert jrate(mixed, d_ss) == 0.5 and trate(mixed, d_ss, sums[5]) == 0.75
    # lanes out of range drop out in both: reset (negative) and overrun
    bad = np.array([-3.0, 4.5])
    assert jrate(bad, d_ss) == trate(bad, d_ss, sums[5]) == 0.0


def test_snapshot_cache_is_one_transfer(monkeypatch):
    engine = ReuseEngine(impl="torch")
    for i in range(3):
        engine.register(f"s{i}", 256, 128, n_layers=2, block_m=2, block_k=64)
    cache = engine.init_cache(2, device="cpu")
    calls = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    snaps = tctl.retune.snapshot_cache(cache)
    assert len(calls) == 1 and set(snaps) == set(cache)


def test_policy_helpers_match_reference():
    """decide_mode (the serve's tuned-delta probe) and split_layer_key."""
    from repro.core.policy import split_layer_key as jsplit
    from repro_torch.core.policy import split_layer_key as tsplit

    rng = np.random.default_rng(4)
    for _ in range(300):
        mode = ["auto", "reuse", "basic"][rng.integers(0, 3)]
        kw = dict(name="s", in_features=int(rng.choice([64, 4096])),
                  out_features=int(rng.choice([64, 4096])), mode=mode)
        tun = dict(sim_threshold=float(rng.random()),
                   min_work_flops=float(10 ** rng.uniform(3, 8)),
                   hysteresis_margin=float(rng.choice([0.0, 0.05, 0.2])))
        sim = float(rng.random())
        cur = [None, "reuse", "basic"][rng.integers(0, 3)]
        got = ReusePolicy(site_tunables={"s": SiteTunables(**tun)}) \
            .decide_mode(ReuseSiteSpec(**kw), sim, current_mode=cur)
        want = JPolicy(site_tunables={"s": JTunables(**tun)}) \
            .decide_mode(JSpec(**kw), sim, current_mode=cur)
        assert got == want
    for key in ("attn_qkv", "attn_qkv@3", "a@b@12", "x@", "x@y", "@7"):
        assert tsplit(key) == jsplit(key)


# --------------------------------------------------- 4. engine-level loops

def _jit_apply(engine):
    """The reference site call, compiled once per spec (as the serve's
    jitted step is rebuilt per spec signature)."""
    fns = {}

    def apply(name, x, w, entry):
        spec = engine.sites[name]
        fn = fns.get((name, spec))
        if fn is None:
            fn = fns[(name, spec)] = jax.jit(
                lambda x, w, e, name=name: engine.apply(name, x, w, None, e))
        return fn(x, w, entry)
    return apply


def scenario_engine(pkg, scenario):
    """The engine a scenario starts from: its site and initial policy."""
    p = PKGS[pkg]
    if scenario == "budget":
        policy = p["policy"](site_tunables={"s": p["tunables"](
            sim_threshold=0.0, min_work_flops=0.0, exec_path="ragged",
            max_active_k=1, block_k=64)})
        engine = p["engine"](policy=policy, impl=p["impl"])
        engine.register("s", 256, 64, block_m=2, block_k=64)   # gk = 4
    else:
        engine = p["engine"](policy=p["policy"](min_work_flops=0.0),
                             impl=p["impl"])
        engine.register("s", 256, 128, n_layers=2, block_m=2, block_k=64)
    return engine


def budget_scenario(pkg, journal_path=None):
    """The reference's budget-loop test, on the ragged path: a half-churning
    stream whose live tile count overflows the budget widens it; a sticky
    stream re-tightens it."""
    p = PKGS[pkg]
    engine = scenario_engine(pkg, "budget")
    ctl = p["ctl"].Controller(p["ctl"].ControlConfig(
        min_window_steps=2, tighten_floor_streak=3,
        fit=p["fit"](low_efficiency=0.0, high_efficiency=1.01),
        journal_path=journal_path))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    base = rng.normal(size=(2, 256)).astype(np.float32)
    xs = [base]
    for _ in range(2, 8):
        x = base.copy()
        x[:, :128] = rng.normal(size=(2, 128))
        xs.append(x)
    xs += [base] * 8
    return _drive(pkg, engine, ctl, {"s": w}, [{"s": x} for x in xs], 2)


def oscillating_scenario(pkg, journal_path=None):
    """The reference's guardrail test: an alternating high/low-similarity
    stream on a stacked site, the solved threshold pinned at 0.5."""
    p = PKGS[pkg]
    engine = scenario_engine(pkg, "oscillating")
    ctl = p["ctl"].Controller(p["ctl"].ControlConfig(
        min_window_steps=3, journal_path=journal_path,
        fit=p["fit"](min_threshold=0.5, max_threshold=0.5)))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    sticky = rng.normal(size=(2, 256)).astype(np.float32)
    xs = []
    for i in range(1, 49):
        high = ((i - 1) // 8) % 2 == 0
        xs.append({"s": sticky if high else
                   rng.normal(size=(2, 256)).astype(np.float32)})
    return _drive(pkg, engine, ctl, {"s": w}, xs, 4)


def _drive(pkg, engine, ctl, weights, xs, every):
    """Feed the stream (every layer of a stacked site the same input) and
    run the controller every `every` evaluations."""
    if pkg == "ref":
        cache = engine.init_cache(2)
        apply = _jit_apply(engine)
    else:
        cache = engine.init_cache(2, device="cpu")
    for i, step in enumerate(xs, start=1):
        for name, x in step.items():
            w = weights[name]
            n_layers = engine.stacking.get(name, 0)
            lanes = range(n_layers) if n_layers else [None]
            for lane in lanes:
                if pkg == "ref":
                    entry = cache[name]
                    if lane is not None:
                        entry = jax.tree.map(lambda a: a[lane], entry)
                    _, new, _ = apply(name, jnp.asarray(x), jnp.asarray(w),
                                      entry)
                    if lane is None:
                        cache[name] = new
                    else:
                        cache[name] = jax.tree.map(
                            lambda a, b: a.at[lane].set(b), cache[name], new)
                else:
                    entry = (cache[name] if lane is None
                             else engine.layer_view(cache, lane)[name])
                    engine.apply(name, torch.from_numpy(x),
                                 torch.from_numpy(w), None, entry)
        if i % every == 0:
            ctl.step(engine, cache, step=i)
    return engine, cache, ctl


def _spec_dict(engine):
    return {n: dataclasses.asdict(s) for n, s in engine.sites.items()}


def _table(engine):
    return {k: t.to_dict() for k, t in engine.policy.site_tunables.items()}


SCENARIOS = {"budget": budget_scenario, "oscillating": oscillating_scenario}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_level_loops_match_reference(scenario):
    je, jc, jc_ctl = SCENARIOS[scenario]("ref")
    te, tc, tc_ctl = SCENARIOS[scenario]("port")
    jrows, trows = journal_rows(jc_ctl), journal_rows(tc_ctl)
    assert trows == jrows
    assert _spec_dict(te) == _spec_dict(je)
    assert _table(te) == _table(je)
    assert te.exec_cooldown == je.exec_cooldown
    assert_caches_match(jc, tc)
    for name in tc:
        np.testing.assert_array_equal(te.entry_mode_ids(tc[name]),
                                      je.entry_mode_ids(jc[name]))
    assert te.mode_summary(tc) == je.mode_summary(jc)
    kinds = {(r["decision_kind"], r["field"]) for r in trows
             if r["kind"] == "decision"}
    if scenario == "budget":
        budget = [r for r in trows if r.get("decision_kind") == "budget"]
        assert [r["after"] - r["before"] for r in budget][:1] == [1]
        assert any(r["after"] < r["before"] for r in budget)
        assert all("overflow_fallbacks" in r["reason"]
                   for r in budget if r["after"] > r["before"])
    else:
        assert ("mode", "mode") in kinds
        assert int(tc["s"]["sensor"]["suppressed_flips"].max()) >= 1


# ---------------------------------------------------- 6. journals cross-load

def test_journals_cross_load_both_ways(tmp_path):
    """A journal the port wrote loads in the reference's load_journal and
    replays OK there; the reference's loads in the port's and replays to
    the same summary lines; the port's apply_to_engine on a fresh engine
    reconstructs the live run's final specs and policy table."""
    for scenario, fn in SCENARIOS.items():
        tpath, jpath = tmp_path / f"{scenario}_t.jsonl", \
            tmp_path / f"{scenario}_j.jsonl"
        live, live_cache, _ = fn("port", journal_path=str(tpath))
        fn("ref", journal_path=str(jpath))
        trows_in_ref = jctl.load_journal(str(tpath))
        assert jctl.replay_rows(trows_in_ref).ok
        jrows_in_port = tctl.load_journal(str(jpath))
        tres = tctl.replay_rows(jrows_in_port)
        assert tres.ok
        assert tres.summary_lines() == \
            jctl.replay_rows(jctl.load_journal(str(jpath))).summary_lines()
        assert tctl.load_journal(str(tpath)) == trows_in_ref

        # a fresh port engine, registered and tuned as the live one started
        fresh = scenario_engine("port", scenario)
        cache = fresh.init_cache(2, device="cpu")
        summary = tctl.replay.apply_to_engine(
            tctl.load_journal(str(tpath)), fresh, cache)
        assert _spec_dict(fresh) == _spec_dict(live)
        assert _governed_table(fresh) == _governed_table(live)
        assert summary["s"]["modes"] == live.layer_modes(live_cache, "s")
        for lane in ("sim_threshold", "min_work", "mode_id"):
            assert torch.equal(cache["s"]["ctrl"][lane],
                               live_cache["s"]["ctrl"][lane])


def _governed_table(engine):
    """The policy table as it governs the engine: site rows whole, layer
    rows ("site@layer") by the array-resident knobs a layer row carries
    (the journal records those; replay rebuilds the rest of a layer row
    from the site row, in the reference as here)."""
    fields = ("sim_threshold", "min_work_flops", "hysteresis_margin",
              "hysteresis_steps")
    return {k: ({f: d[f] for f in fields} if "@" in k else d)
            for k, d in _table(engine).items()}


def test_replay_chains_the_budget_through_a_block_k_rescale():
    """A budget widen, a block_k retune that rescales the installed budget
    (journaled as a retune row), another widen — the order the card's
    full-width qwen3 closed loop journaled. The port's replay continues the
    installed-budget chain through the rescale, and apply_to_engine lands
    on the live budget; the reference's replay keeps the chains apart and
    reports the second widen as a mismatch."""
    def row(interval, kind, field, before, after, reason):
        return {"kind": "decision", "schema_version": 5, "step": 2 * interval,
                "interval": interval, "site": "s", "decision_kind": kind,
                "field": field, "before": before, "after": after,
                "reason": reason, "layer": None, "shard": None}

    rows = [
        row(1, "budget", "max_active_k", 1, 2,
            "overflow_fallbacks 2/2 evals (100%) > 10%"),
        row(2, "retune", "block_k", 128, 64,
            "window 2 steps, hit 0.24, skip 0.06: block_k 128->64 "
            "(target 64)"),
        row(2, "retune", "max_active_k", 2, 4,
            "rescaled with block_k 128->64 (same covered K extent)"),
        row(3, "budget", "max_active_k", 4, 5,
            "overflow_fallbacks 2/2 evals (100%) > 10%"),
    ]
    got = tctl.replay_rows(rows)
    assert got.ok
    assert got.final_state[("s", "budget", "max_active_k", None, None)] == 5
    ref = jctl.replay_rows(rows)
    assert not ref.ok
    assert (ref.mismatches[0]["before"], ref.mismatches[0]["replayed"]) == \
        (4, 2)
    engine = ReuseEngine(policy=ReusePolicy(site_tunables={"s": SiteTunables(
        exec_path="ragged", max_active_k=1, block_k=128)}), impl="torch")
    engine.register("s", 1024, 64, block_m=2, block_k=128)
    cache = engine.init_cache(2, device="cpu")
    summary = tctl.replay.apply_to_engine(rows, engine, cache)
    assert (summary["s"]["block_k"], summary["s"]["max_active_k"]) == (64, 5)


def test_latency_table_path_is_refused_until_ported(tmp_path):
    """Now that obs/latency.py is ported the path is no longer refused: the
    port's Controller loads the table the reference's loads, and a missing
    file raises as the reference's does."""
    from repro_torch.obs.latency import LatencyTable

    table = LatencyTable()
    table.record("s", None, "basic", 1e-4)
    table.record("s", None, "kernel", 5e-5)
    table.save(str(tmp_path / "t.json"))
    cfg = dict(latency_table_path=str(tmp_path / "t.json"))
    port = tctl.Controller(tctl.ControlConfig(**cfg))
    ref = jctl.Controller(jctl.ControlConfig(**cfg))
    assert port.latency.rows() == ref.latency.rows() == table.rows()
    for ctl in (tctl, jctl):
        with pytest.raises(FileNotFoundError):
            ctl.Controller(ctl.ControlConfig(
                latency_table_path=str(tmp_path / "missing.json")))


def test_torn_journal_tail_loads_as_marker(tmp_path):
    path = tmp_path / "j.jsonl"
    budget_scenario("port", journal_path=str(path))
    text = path.read_text()
    path.write_text(text + '{"kind": "decision", "ste')
    for load in (tctl.load_journal, jctl.load_journal):
        rows = load(str(path))
        assert rows[-1]["kind"] == "torn_tail"
    assert tctl.replay_rows(tctl.load_journal(str(path))).ok


# --------------------------------------------------------- 7. the serve CLI

SERVE = ["--reduced", "--requests", "4", "--batch-slots", "2",
         "--prompt-len", "4", "--cache-len", "24", "--max-new", "5",
         "--reuse", "--device", "cpu"]


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_serve_cli_with_control_on_cpu(capsys, tmp_path, arch):
    path = tmp_path / "journal.jsonl"
    tserve_cli.main(["--arch", arch, *SERVE, "--control-every", "2",
                     "--control-journal", str(path), "--refresh-every", "3"])
    out = capsys.readouterr().out
    assert "--control-every supersedes --refresh-every" in out
    assert "control plane: " in out and "decisions, admission {" in out
    assert "decision journal: " in out and str(path) in out
    rows = tctl.load_journal(str(path))
    assert sum(r["kind"] == "interval" for r in rows) >= 2
    assert tctl.replay_rows(rows).ok and jctl.replay_rows(rows).ok
    # every interval row carries its window id (the serve's events context)
    assert all(r["trace"]["window"] == r["step"] for r in rows
               if r["kind"] == "interval")
    # the replay CLI re-drives it through a fresh engine
    capsys.readouterr()
    assert tctl.replay.main([str(path), "--arch", arch, "--reduced",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "replay OK: trajectory reproduced" in out and "engine " in out
    # a journal alone replays on any host, as the reference's does
    capsys.readouterr()
    assert tctl.replay.main([str(path)]) == 0
    assert "replay OK: trajectory reproduced" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # an --arch engine defaults to the card and fails loudly without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tctl.replay.main([str(path), "--arch", arch, "--reduced"])


def test_serve_affinity_without_controller_places_by_prediction():
    args = tserve_cli.build_parser().parse_args(
        ["--arch", "qwen3-32b", *SERVE, "--affinity"])
    cfg = tserve_cli.get_config("qwen3-32b").reduced()
    res = tserve_cli.run(cfg, args)
    assert res["stats"]["affinity_placements"] > 0
    assert res["controller"] is None


def test_serve_control_journal_needs_control_every(capsys, monkeypatch):
    """The port's CLI refuses `--control-journal` without `--control-every`
    with the reference's message (raised, as the port's other argument
    errors are)."""
    argv = ["--arch", "qwen3-32b", "--reduced", "--reuse",
            "--control-journal", "j.jsonl"]
    with pytest.raises(ValueError) as e:
        tserve_cli.main(argv + ["--device", "cpu"])
    from repro.launch import serve as jserve_cli

    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as je:
        jserve_cli.main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert je.value.code == 2
    assert str(e.value) == ref_err.split("error: ")[1] == \
        "--control-journal requires --control-every"
    for flag in (["--affinity"], ["--control-every", "2"]):
        with pytest.raises(ValueError, match=f"{flag[0]} requires --reuse"):
            tserve_cli.main(["--arch", "qwen3-32b", "--reduced", *flag,
                             "--device", "cpu"])


# --------------------------------------------------------------- 8. in place

def _leaf_ptrs(cache):
    out = {}
    for name, entry in cache.items():
        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                elif isinstance(v, torch.Tensor):
                    out[prefix + k] = v.data_ptr()
                else:  # the mode mirror
                    out[prefix + k] = v.__array_interface__["data"][0]
        walk(entry, f"{name}.")
    return out


def test_controller_writes_the_cache_in_place():
    """Across controller intervals that move tunables, block_k, budgets,
    exec paths and modes (the reduced qwen3 closed loop), every tensor leaf
    of the reuse cache and the mode mirrors keep their storage."""
    ctl = tctl.Controller(tctl.ControlConfig(min_window_steps=2))
    seen = {}

    def on_step(i, engine, cache):
        if i == 1:
            seen["ptrs"] = _leaf_ptrs(cache)
        if i % 2 == 0:
            ctl.step(engine, cache, step=i)
            assert _leaf_ptrs(cache) == seen["ptrs"], f"interval at step {i}"

    md = run_measured_decode("qwen3-32b", steps=26, batch=2, correlation=1.0,
                             burst=(19, 22), on_step=on_step, device="cpu")
    assert _leaf_ptrs(md.cache) == seen["ptrs"]
    moved = {(d.kind, d.field) for r in ctl.reports for d in r.decisions}
    assert {("retune", "sim_threshold"), ("retune", "block_k"),
            ("budget", "max_active_k"), ("exec", "exec_path"),
            ("mode", "mode")} <= moved
