"""The port's guard plane (`repro_torch.guard`) against the reference's
(`repro.guard`), on the CPU.

Each case of tests/test_guard.py has a counterpart here. The same inputs,
made with numpy from a seed, go through both packages — the reference's
engine at impl="pallas" (the compiled-XLA tier on this host, as
tests/test_torch_control.py forces it), the port's at impl="torch":

  - the sentinel lanes and `evaluate_snapshot`'s trips equal for each
    corruption class, stacked and unstacked, and for the conservation
    window with a block_k move; the lanes ride the port's one ctrl
    snapshot transfer;
  - the breaker's lifecycle (trip, probation, a stall voiding probation,
    re-admission, backoff), garbage ctrl lanes rebuilt from the policy, the
    shadow check passing on each exec path and failing when forced: equal
    decisions, lane states and cache lanes;
  - the injector's `from_spec` round trip and errors, each cache scenario
    firing at its step (caches equal, the port writing in place), lying
    telemetry; the torn journal tolerated at the tail, refused mid-file;
  - the reference's chaos run at reduced size through both packages:
    journals equal row for row, outputs bitwise equal, post-containment
    outputs finite and bitwise equal to the basic-mode oracle, and the
    negative control tripping nothing;
  - every cache leaf keeps its storage across a quarantine, a scrub and a
    re-admission (the compiled step's CUDA graphs read those tensors);
  - the straggler watchdog on given step times (never the wall clock).

Integer-valued operands at fixed_scale 1.0 keep every f32 sum exact, so the
two packages' products agree bitwise whatever their summation order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.control as jctl
import repro.guard as jguard
from repro.control.report import DecisionJournal as JJournal
from repro.core import ReuseEngine as JEngine
from repro.core import ReusePolicy as JPolicy
from repro.core import SiteTunables as JTunables
from repro_torch import control as tctl
from repro_torch import guard as tguard
from repro_torch.control.report import DecisionJournal as TJournal
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy, SiteTunables
from test_torch_engine import assert_caches_match

L, M, K, N = 2, 2, 64, 32

PKGS = {
    "ref": dict(engine=JEngine, policy=JPolicy, tunables=JTunables,
                guard=jguard, ctl=jctl, journal=JJournal, impl="pallas"),
    "port": dict(engine=ReuseEngine, policy=ReusePolicy,
                 tunables=SiteTunables, guard=tguard, ctl=tctl,
                 journal=TJournal, impl="torch"),
}


def make_engine(pkg, mode="auto", site="stack", exec_path="dense",
                stacked=True):
    """The reference test's site: integer-exact (scale 1.0), a permissive
    policy so lanes sit in reuse mode — the state a poisoned prev_out lane
    persists in."""
    p = PKGS[pkg]
    policy = p["policy"](site_tunables={site: p["tunables"](
        sim_threshold=0.0, min_work_flops=0.0, exec_path=exec_path)})
    eng = p["engine"](policy=policy, impl=p["impl"])
    eng.register(site, K, N, n_layers=L if stacked else 0, block_m=2,
                 block_k=32, mode=mode)
    eng.sites[site] = dataclasses.replace(eng.sites[site], fixed_scale=1.0)
    return eng


def make_cache(pkg, eng):
    return eng.init_cache(M) if pkg == "ref" else eng.init_cache(
        M, device="cpu")


def sticky_inputs():
    rng = np.random.default_rng(7)
    return rng.integers(-3, 4, size=(L, M, K)).astype(np.float32)


def int_weights():
    rng = np.random.default_rng(8)
    return rng.integers(-2, 3, size=(K, N)).astype(np.float32)


def stepper(pkg, eng, w, site="stack"):
    """One step of the stacked site: layer l reads xs[l]. Returns
    step(xs, cache) -> outputs [L, M, N] as numpy (the cache advances)."""
    if pkg == "ref":
        wj = jnp.asarray(w)

        @jax.jit
        def scan(xs, entry):
            def body(carry, sl):
                x_l, e_l = sl
                out, new_e, _ = eng.apply(site, x_l, wj, None, e_l)
                return carry, (out, new_e)

            _, (outs, new_entry) = jax.lax.scan(body, 0, (xs, entry))
            return outs, new_entry

        def step(xs, cache):
            outs, cache[site] = scan(jnp.asarray(xs), cache[site])
            return np.asarray(outs)
        return step
    wt = torch.from_numpy(w)

    def step(xs, cache):
        outs = [eng.apply(site, torch.from_numpy(xs[layer]), wt, None,
                          eng.layer_view(cache, layer)[site])[0]
                for layer in range(L)]
        return torch.stack(outs).numpy()
    return step


def poke(pkg, cache, site, path, index, value):
    """cache[site][path...][index] = value, functionally (ref) or in place
    (port)."""
    entry = cache[site]
    if pkg == "port":
        leaf = entry
        for key in path:
            leaf = leaf[key]
        leaf[index] = value
        return
    *outer, last = path
    parents = [entry]
    for key in outer:
        parents.append(parents[-1][key])
    new = parents[-1][last].at[index].set(value)
    for parent, key in zip(reversed(parents), reversed(path)):
        new = dict(parent, **{key: new})
    cache[site] = new


def host(tree):
    """A cache entry or lane dict as numpy copies (the port's tensors are
    written in place later)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy().copy()
    return np.array(tree)


def assert_lanes_equal(jl, tl):
    jl, tl = host(jl), host(tl)
    assert set(tl) == set(jl)
    for k in jl:
        assert tl[k].dtype == jl[k].dtype, k
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)


def trips(ts):
    return [dataclasses.astuple(t) for t in ts]


def decisions(ds):
    return [dataclasses.asdict(d) for d in ds]


# ------------------------------------------------------------ array sentinels

CORRUPTIONS = {
    "clean": [],
    "nonfinite_out": [(("prev_out",), (1, 0, 0), float("nan"))],
    "sim_range": [(("sim_ema",), (0, 0), 1.5)],
    "ctrl_range": [(("ctrl", "mode_id"), (0,), 7),
                   (("ctrl", "cooldown"), (0,), -3),
                   (("ctrl", "sim_threshold"), (0,), 9.0)],
}
WANT = {"clean": [], "nonfinite_out": [(1, "nonfinite_out")],
        "sim_range": [(0, "sim_range")], "ctrl_range": [(0, "ctrl_range")]}


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("what", list(CORRUPTIONS))
def test_sentinel_lanes_detect_each_corruption_class(what, stacked):
    got = {}
    for pkg in PKGS:
        eng = make_engine(pkg, stacked=stacked)
        cache = make_cache(pkg, eng)
        for path, index, value in CORRUPTIONS[what]:
            poke(pkg, cache, "stack", path,
                 index if stacked else index[1:], value)
        lanes = PKGS[pkg]["guard"].sentinel_lanes(cache["stack"])
        got[pkg] = (lanes, trips(PKGS[pkg]["guard"].evaluate_snapshot(
            "stack", host(lanes), stacked=stacked)))
    assert_lanes_equal(got["ref"][0], got["port"][0])
    assert got["port"][1] == got["ref"][1]
    layer = (lambda i: i) if stacked else (lambda i: None)
    assert [(t[1], t[2]) for t in got["port"][1]] == [
        (layer(i), c) for i, c in WANT[what]]
    if what == "nonfinite_out":
        assert "1 non-finite" in got["port"][1][0][3]
    if what == "ctrl_range":
        for name in ("mode_id", "cooldown", "sim_threshold"):
            assert name in got["port"][1][0][3]


def test_sentinel_counter_conservation_window():
    """Δskipped + Δcomputed must equal Δsteps·gm·gk per layer; a block_k
    move (tiles_per_eval=None) invalidates one window instead of tripping
    falsely — equal trips in both packages."""
    prev = {"skipped_l": np.array([4, 4]), "computed_l": np.array([0, 0]),
            "steps_l": np.array([1, 1])}
    ok = {"bad_out": np.zeros(2, np.int32), "bad_sim": np.zeros(2, np.int32),
          "skipped_l": np.array([10, 8]), "computed_l": np.array([2, 4]),
          "steps_l": np.array([3, 3])}
    broken = dict(ok, skipped_l=np.array([11, 8]))  # phantom skip, layer 0
    for lanes, tiles, want in ((ok, 4, []), (broken, 4, [(0, "conservation")]),
                               (broken, None, [])):
        got = {pkg: trips(PKGS[pkg]["guard"].evaluate_snapshot(
            "s", lanes, stacked=True, tiles_per_eval=tiles, prev=prev))
            for pkg in PKGS}
        assert got["port"] == got["ref"]
        assert [(t[1], t[2]) for t in got["port"]] == want
    t = tguard.evaluate_snapshot("s", broken, stacked=True, tiles_per_eval=4,
                                 prev=prev)
    assert "9 != " in t[0].evidence and "8" in t[0].evidence


def test_sentinel_lanes_ride_the_ctrl_snapshot(monkeypatch):
    """The lanes arrive inside the engine's one control snapshot (one
    device→host copy) when asked for, equal to the reference's snapshot
    lanes; a snapshot that does not ask carries the ctrl lanes alone."""
    snaps = {}
    for pkg in PKGS:
        eng = make_engine(pkg)
        cache = make_cache(pkg, eng)
        step = stepper(pkg, eng, int_weights())
        step(sticky_inputs(), cache)
        poke(pkg, cache, "stack", ("prev_out",), (1, 0, 0), float("inf"))
        if pkg == "port":
            calls = []
            orig = torch.Tensor.cpu

            def counting_cpu(self, *a, **kw):
                calls.append(tuple(self.shape))
                return orig(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
            snaps[pkg] = eng.ctrl_snapshot(cache, sentinels=True)["stack"]
            monkeypatch.undo()
            assert len(calls) == 1
            plain = eng.ctrl_snapshot(cache)["stack"]
            assert "bad_out" not in plain and "steps_l" not in plain
            assert plain["quarantine"].tolist() == \
                snaps[pkg]["quarantine"].tolist()
        else:
            snaps[pkg] = eng.ctrl_snapshot(cache)["stack"]
    lanes = ("bad_out", "bad_sim", "ctrl_bad", "quarantine", "skipped_l",
             "computed_l", "steps_l")
    for lane in lanes:
        assert lane in snaps["port"], lane
    assert_lanes_equal({k: snaps["ref"][k] for k in lanes},
                       {k: snaps["port"][k] for k in lanes})
    assert snaps["port"]["bad_out"].tolist() == [0, 1]


# ------------------------------------------------------- quarantine breaker

def lifecycle(pkg):
    """The reference test's breaker sequence; returns what each pass saw
    and wrote, comparable across the packages."""
    g = PKGS[pkg]["guard"]
    eng = make_engine(pkg)
    cache = make_cache(pkg, eng)
    br = g.QuarantineBreaker(g.GuardConfig(quarantine_intervals=1,
                                           probation_windows=1))
    seen = []

    def record(rep):
        seen.append(dict(
            trips=trips(rep.trips), decisions=decisions(rep.decisions),
            frozen=rep.frozen_sites, stalled=rep.stalled,
            quarantined=rep.quarantined_lanes, states=br.lane_states(),
            modes=eng.layer_modes(cache, "stack"),
            exec_cooldown=dict(eng.exec_cooldown),
            stall_windows=br.stall_windows,
            lockouts={k: v.lockout for k, v in br._lanes.items()},
            entry=host(cache["stack"])))

    poke(pkg, cache, "stack", ("prev_out",), (1, 0, 0), float("nan"))
    record(br.step(eng, cache, step=1))
    record(br.step(eng, cache, step=2))
    br.note_stall({"step": 2, "seconds": 0.5, "median": 0.01,
                   "action": "recommend re-shard / evict host"})
    record(br.step(eng, cache, step=3))
    record(br.step(eng, cache, step=4))
    poke(pkg, cache, "stack", ("prev_out",), (1, 0, 0), float("inf"))
    record(br.step(eng, cache, step=5))
    return seen, eng, cache


def assert_entries_equal(jentry, tentry):
    flat = lambda e, p="": (  # noqa: E731
        {k2: v2 for k, v in e.items() for k2, v2 in flat(v, f"{p}{k}.").items()}
        if isinstance(e, dict) else {p[:-1]: e})
    je, te = flat(jentry), flat(tentry)
    assert set(je) == set(te)
    for k in je:
        assert te[k].dtype == je[k].dtype, k
        np.testing.assert_array_equal(te[k], je[k], err_msg=k)


def test_breaker_lifecycle_trip_probation_readmit_backoff():
    (jseen, _, _), (tseen, teng, tcache) = lifecycle("ref"), lifecycle("port")
    for j, t in zip(jseen, tseen):
        jentry, tentry = j.pop("entry"), t.pop("entry")
        tentry.pop("mode_host")
        assert t == j
        assert_entries_equal(jentry, tentry)
    first, drained, stalled, readmit, reoffense = tseen
    assert first["quarantined"] == 1 and first["frozen"] == {"stack"}
    assert first["states"][("stack", 1)] == "quarantined"
    assert first["modes"][1] == "basic"
    assert "nonfinite_out" in first["decisions"][0]["reason"]
    assert drained["states"][("stack", 1)] == "probation"
    assert stalled["stalled"] and stalled["stall_windows"] == 1
    assert stalled["states"][("stack", 1)] == "probation"
    assert readmit["states"][("stack", 1)] == "active"
    assert reoffense["lockouts"][("stack", 1)] == 2
    assert "offense #2" in reoffense["decisions"][0]["reason"]
    assert int(tcache["stack"]["ctrl"]["quarantine"][1]) == 2
    # the mode mirror follows the device lane through every write
    np.testing.assert_array_equal(tcache["stack"]["mode_host"],
                                  tcache["stack"]["ctrl"]["mode_id"].numpy())


def test_breaker_rebuilds_garbage_ctrl_lanes_from_policy():
    out = {}
    for pkg in PKGS:
        g = PKGS[pkg]["guard"]
        eng = make_engine(pkg)
        cache = make_cache(pkg, eng)
        inj = g.FaultInjector("ctrl-garbage", at_step=1, layer=0)
        cache = inj.on_cache_update(cache, 1)
        assert int(np.asarray(host(cache["stack"]["ctrl"]["mode_id"]))[0]) == 7
        assert eng.layer_modes(cache, "stack") == ["reuse", "reuse"]
        rep = g.QuarantineBreaker().step(eng, cache, step=1)
        out[pkg] = (trips(rep.trips), decisions(rep.decisions),
                    host(cache["stack"]["ctrl"]))
    assert out["port"][:2] == out["ref"][:2]
    assert_entries_equal(out["ref"][2], out["port"][2])
    ctrl = out["port"][2]
    t = make_engine("port").policy.resolve("stack", layer=0)
    assert [t[2] for t in out["port"][0]] == ["ctrl_range"]
    assert ctrl["mode_id"][0] in (0, 1) and ctrl["cooldown"][0] >= 0
    assert float(ctrl["sim_threshold"][0]) == np.float32(t.sim_threshold)
    assert float(ctrl["min_work"][0]) == np.float32(t.min_work_flops)


@pytest.mark.parametrize("exec_path", ["dense", "kernel", "ragged"])
def test_shadow_check_proves_current_operating_point(exec_path):
    """The shadow probe passes on each path the port runs, with the
    reference's verdict and detail."""
    got = {pkg: PKGS[pkg]["guard"].shadow_check(
        make_engine(pkg, exec_path=exec_path), "stack", seed=3)
        for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"][0] and "bitwise-exact" in got["port"][1]


def test_shadow_check_failure_quarantines_the_site(monkeypatch):
    """A diverging substrate quarantines the whole site (layer None)."""
    out = {}
    for pkg, mod in (("ref", "repro.guard.quarantine"),
                     ("port", "repro_torch.guard.quarantine")):
        g = PKGS[pkg]["guard"]
        eng = make_engine(pkg)
        cache = make_cache(pkg, eng)
        br = g.QuarantineBreaker(g.GuardConfig(shadow_every=1))
        monkeypatch.setattr(f"{mod}.shadow_check",
                            lambda *a, **k: (False, "forced divergence"))
        rep = br.step(eng, cache, step=1)
        out[pkg] = (rep.shadow, trips(rep.trips), decisions(rep.decisions),
                    br.lane_states(), eng.layer_modes(cache, "stack"),
                    host(cache["stack"]["sensor"]["sentinel_trips"]))
    assert out["port"][:5] == out["ref"][:5]
    np.testing.assert_array_equal(out["port"][5], out["ref"][5])
    shadow, ts, _, states, modes, _ = out["port"]
    assert shadow == ("stack", False, "forced divergence")
    assert [(t[2], t[1]) for t in ts] == [("shadow", None)]
    assert states[("stack", None)] == "quarantined"
    assert set(modes) == {"basic"}


# ----------------------------------------------------------- fault injector

def test_injector_spec_roundtrip_and_validation():
    assert set(tguard.SCENARIOS) == set(jguard.SCENARIOS)
    for name, params in jguard.SCENARIOS.items():
        mine = dict(tguard.SCENARIOS[name])
        if name == "lying-telemetry":  # a NaN, unequal to itself
            assert math.isnan(mine.pop("value"))
            params = {k: v for k, v in params.items() if k != "value"}
        assert mine == params, name
    for spec in ("poison-nan:at_step=3,site=s,layer=1,seed=5", "stall",
                 "stall:seconds=0.5,at_step=2", "poison-counters:bump=9",
                 "lying-telemetry:value=1.7"):
        t, j = (g.FaultInjector.from_spec(spec) for g in (tguard, jguard))
        assert (t.scenario, t.site, t.layer, t.seed, t.params) == (
            j.scenario, j.site, j.layer, j.seed, j.params)
    inj = tguard.FaultInjector.from_spec(
        "poison-nan:at_step=3,site=s,layer=1,seed=5")
    assert (inj.scenario, inj.site, inj.layer, inj.seed) == (
        "poison-nan", "s", 1, 5)
    assert inj.params["at_step"] == 3
    for call, match in ((lambda g: g.FaultInjector("nope"),
                         "unknown fault scenario"),
                        (lambda g: g.FaultInjector("stall", bogus=1),
                         "unknown"),
                        (lambda g: g.FaultInjector.from_spec("stall:seconds"),
                         "bad injector spec")):
        msgs = []
        for g in (jguard, tguard):
            with pytest.raises(ValueError, match=match) as e:
                call(g)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("scenario,kw", [
    ("poison-nan", dict(at_step=4)),
    ("poison-sim", dict(at_step=1, layer=1)),
    ("ctrl-garbage", dict(at_step=2, layer=1)),
    ("poison-counters", dict(at_step=1, bump=5)),
])
def test_injector_cache_scenarios_fire_deterministically(scenario, kw):
    """Each cache scenario fires at its step only, leaves the reference's
    cache and the port's equal, and writes the port's in place."""
    out = {}
    for pkg in PKGS:
        g = PKGS[pkg]["guard"]
        eng = make_engine(pkg)
        cache = make_cache(pkg, eng)
        stepper(pkg, eng, int_weights())(sticky_inputs(), cache)
        inj = g.FaultInjector(scenario, **kw)
        assert inj.on_cache_update(cache, kw["at_step"] - 1) is cache
        assert not inj.fired
        if pkg == "port":
            ptrs = {k: t.data_ptr() for k, t in leaves(cache).items()}
        got = inj.on_cache_update(cache, kw["at_step"])
        if pkg == "port":
            assert got is cache
            assert {k: t.data_ptr() for k, t in leaves(got).items()} == ptrs
        out[pkg] = (inj.fired, got)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0][0]["step"] == kw["at_step"]
    jc, tc = out["ref"][1], out["port"][1]
    assert_caches_match(jc, tc)
    np.testing.assert_array_equal(tc["stack"]["mode_host"],
                                  tc["stack"]["ctrl"]["mode_id"].numpy())
    if scenario == "poison-nan":
        assert out["port"][0][0]["layer"] == 0
        assert not np.isfinite(tc["stack"]["prev_out"].numpy()).all()
    elif scenario == "poison-sim":
        assert math.isnan(float(tc["stack"]["sim_ema"][1, 0]))
    elif scenario == "ctrl-garbage":
        assert int(tc["stack"]["mode_host"][1]) == 7
    else:
        assert int(tc["stack"]["sensor"]["skipped_tiles"].sum()) == int(
            np.asarray(jc["stack"]["sensor"]["skipped_tiles"]).sum())


def test_lying_telemetry_is_injected_and_rejected():
    """The injector forges the retirement telemetry once; the port's
    admission predictor rejects the non-finite report and clamps
    out-of-range ones, as the reference's does."""
    t = {"slot": 0, "steps": 5, "hit_rate": 0.5}
    for g in (jguard, tguard):
        lie = g.FaultInjector("lying-telemetry", at_step=2, value=float("nan"))
        assert lie.on_telemetry(t, 1) == t
        lied = lie.on_telemetry(t, 2)
        assert math.isnan(lied["hit_rate"]) and t["hit_rate"] == 0.5
        assert lie.on_telemetry(t, 3) == t

    class _Req:
        def __init__(self, rid, session, hit):
            self.rid, self.slot, self.session = rid, 0, session
            self.telemetry = {"slot": 0, "steps": 5, "hit_rate": hit,
                              "n_sites": 1}

    preds = {"ref": jctl.AdmissionPredictor(decay=1.0, prior=0.5),
             "port": tctl.AdmissionPredictor(decay=1.0, prior=0.5)}
    for i, (session, hit) in enumerate((("liar", float("nan")),
                                        ("liar", float("inf")),
                                        ("hype", 5.0), ("doom", -2.0))):
        for pred in preds.values():
            pred.observe_retirement(_Req(i, session, hit))
    assert preds["port"].sessions == preds["ref"].sessions
    assert preds["port"].stats() == preds["ref"].stats()
    assert "liar" not in preds["port"].sessions
    assert preds["port"].rejected_observations == 2
    assert preds["port"].sessions == {"hype": 1.0, "doom": 0.0}


def _report(ctl, step, interval, before, after):
    return ctl.ControlReport(
        step=step, interval=interval, window_steps={}, retrace={},
        decisions=[ctl.Decision(step=step, site="s", kind="retune",
                                field="sim_threshold", before=before,
                                after=after, reason="test")])


def test_torn_journal_tail_tolerated_mid_file_refused(tmp_path):
    path = tmp_path / "port.jsonl"
    j = TJournal(str(path))
    j.append(_report(tctl.report, 1, 1, 0.1, 0.2))
    j.append(_report(tctl.report, 2, 2, 0.2, 0.3))
    assert len(tctl.load_journal(str(path))) == 4
    whole = path.read_bytes()
    # both injectors tear the same bytes at the same place
    torn = {}
    for pkg in PKGS:
        copy = tmp_path / f"copy_{pkg}.jsonl"
        copy.write_bytes(whole)
        PKGS[pkg]["guard"].FaultInjector("torn-journal").tear_journal(copy)
        torn[pkg] = copy.read_bytes()
    assert torn["port"] == torn["ref"] and len(torn["port"]) < len(whole)
    tguard.FaultInjector("torn-journal").tear_journal(path)
    rows = tctl.load_journal(str(path))
    assert rows[-1]["kind"] == "torn_tail" and rows[-1]["prefix"]
    assert tctl.replay_rows(rows).ok
    lines = path.read_text().splitlines()
    lines[1] = lines[1][: len(lines[1]) // 2]
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="mid-file"):
        tctl.load_journal(str(path))


# ---------------------------------------------------------------- chaos e2e

def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree} if isinstance(tree, torch.Tensor) else {}


def chaos(pkg, inject, journal=None, on_interval=None):
    """The reference's chaos run: poison-nan into layer 0 at step 5, the
    Controller with the breaker every 2 steps (the retuner held off by
    min_window_steps=100), 14 steps beside the basic-mode oracle."""
    p = PKGS[pkg]
    g = p["guard"]
    w = int_weights()
    xs = sticky_inputs()
    eng = make_engine(pkg)
    cache = make_cache(pkg, eng)
    step = stepper(pkg, eng, w)
    oracle = make_engine(pkg, mode="basic")
    ocache = make_cache(pkg, oracle)
    ostep = stepper(pkg, oracle, w)
    inj = g.FaultInjector("poison-nan", at_step=5, layer=0) if inject else None
    br = g.QuarantineBreaker(g.GuardConfig(quarantine_intervals=1,
                                           probation_windows=1))
    ctl = p["ctl"].Controller(
        p["ctl"].ControlConfig(min_window_steps=100),
        journal=p["journal"](journal) if journal else None, guard=br)
    outs = []
    for t in range(1, 15):
        outs.append((step(xs, cache), ostep(xs, ocache)))
        if inj is not None:
            cache = inj.on_cache_update(cache, t)
        if t % 2 == 0:
            rep = ctl.step(eng, cache, step=t)
            assert not rep.changed  # containment never changes a spec
            if on_interval is not None:
                on_interval(t, cache)
    return dict(outs=outs, eng=eng, cache=cache, br=br, ctl=ctl, inj=inj)


def test_chaos_quarantine_e2e_bitwise_recovery(tmp_path):
    """Both packages: the NaN reaches step 6's output; every step from 7 is
    finite and bitwise equal to the basic-mode oracle; the journals are
    equal row for row and chain quarantined → probation → active; the
    lane re-promotes to reuse; the same stream without injection trips
    nothing."""
    runs = {pkg: chaos(pkg, True, str(tmp_path / f"{pkg}.jsonl"))
            for pkg in PKGS}
    ref, port = runs["ref"], runs["port"]
    rows = {pkg: [{k: v for k, v in r.items() if k != "ts"}
                  for r in tctl.load_journal(str(tmp_path / f"{pkg}.jsonl"))]
            for pkg in PKGS}
    assert rows["port"] == rows["ref"]
    for t, ((jo, joo), (to, too)) in enumerate(
            zip(ref["outs"], port["outs"]), start=1):
        np.testing.assert_array_equal(to, jo, err_msg=f"step {t}")
        np.testing.assert_array_equal(too, joo, err_msg=f"oracle step {t}")
        if t == 6:
            assert not np.isfinite(to).all(), "fault never reached an output"
        elif t >= 7:
            assert np.isfinite(to).all(), f"step {t} not contained"
            np.testing.assert_array_equal(to, too, err_msg=f"step {t}")
    assert port["inj"].fired == ref["inj"].fired
    assert port["br"].total_trips == ref["br"].total_trips >= 1
    assert port["br"].lane_states() == ref["br"].lane_states()
    assert port["br"].lane_states()[("stack", 0)] == "active"
    assert int(port["cache"]["stack"]["ctrl"]["quarantine"].max()) == 0
    assert port["eng"].layer_modes(port["cache"], "stack")[0] == "reuse"
    assert_caches_match(ref["cache"], port["cache"])
    chain = [(r["before"], r["after"]) for r in rows["port"]
             if r.get("decision_kind") == "quarantine"
             and r.get("field") == "state" and r.get("layer") == 0]
    assert chain == [("active", "quarantined"), ("quarantined", "probation"),
                     ("probation", "active")]
    assert tctl.replay_rows(rows["port"]).ok
    # negative control: the same stream, no injection -> zero trips
    for pkg in PKGS:
        clean = chaos(pkg, False)
        assert clean["br"].total_trips == 0
        assert not any(d.kind == "quarantine" for r in clean["ctl"].reports
                       for d in r.decisions)


def test_cache_leaves_stay_in_place_across_quarantine():
    """The chaos run's quarantine, scrub, probation and re-admission write
    every cache leaf in place: each tensor keeps its storage, the mode
    mirror its array, and the mirror equals the device lane."""
    eng = make_engine("port")
    before = {k: t.data_ptr() for k, t in leaves(make_cache("port", eng))
              .items()}
    assert before
    seen = {}

    def on_interval(t, cache):
        ptrs = {k: v.data_ptr() for k, v in leaves(cache).items()}
        seen.setdefault("ptrs", ptrs)
        seen.setdefault("mirror", cache["stack"]["mode_host"])
        assert ptrs == seen["ptrs"], f"interval at step {t}"
        assert cache["stack"]["mode_host"] is seen["mirror"]
        np.testing.assert_array_equal(cache["stack"]["mode_host"],
                                      cache["stack"]["ctrl"]["mode_id"].numpy())

    run = chaos("port", True, on_interval=on_interval)
    kinds = [(d.kind, d.after) for r in run["ctl"].reports
             for d in r.decisions if d.kind == "quarantine"]
    assert ("quarantine", "quarantined") in kinds
    assert ("quarantine", "active") in kinds
    assert len(seen["ptrs"]) == len(before)


# ----------------------------------------------------------------- watchdog

def test_watchdog_matches_reference_on_given_times():
    """Given step times (the wall clock is never read): the same events,
    step by step, as the reference's watchdog."""
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.010, 0.014, size=40))
    times[12] = 0.5   # a stall after min_samples
    times[3] = 0.5    # one before min_samples: no verdict yet
    times[30] = 0.021  # under 2x the median
    wds = {"ref": jguard.StragglerWatchdog(),
           "port": tguard.StragglerWatchdog()}
    for i, dt in enumerate(times, start=1):
        got = {k: wd.observe(i, dt) for k, wd in wds.items()}
        assert got["port"] == got["ref"]
    assert wds["port"].events == wds["ref"].events
    assert [e["step"] for e in wds["port"].events] == [13]
