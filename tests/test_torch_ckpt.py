"""Checkpointing in the port (`repro_torch.ckpt`, `repro_torch.control.
restore`, `serve --cache-ckpt`) against the JAX package, on the CPU.

The reference's checkpoint tests (`tests/test_ckpt.py`) on a state of
torch tensors (f32, bf16, nested int32, a 0-d int32); each package
restores the other's checkpoints bitwise (that state, the reduced qwen3
reuse cache after a few decode steps, a `shard_sites(2)` cache), with the
same manifest leaves and npz keys; both raise `CorruptCheckpointError` on
the same damage with the same message; the restore precedence gives the
reference's decisions (`pytest.approx` at its `_REL_TOL`) and journal rows;
and the two serves take each other's `--cache-ckpt` checkpoints and print
the same save and restore lines.
"""

import contextlib
import io
import json
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import ARCHS as JARCHS
from repro.control.report import DecisionJournal as JJournal
from repro.control.restore import resolve_restored_ctrl as jresolve
from repro.core import ReuseEngine as JEngine
from repro.core import ReusePolicy as JPolicy
from repro.core import SiteTunables as JTunables
from repro.models import init_params as jinit_params
from repro.serve import serve_step as jserve
from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    CorruptCheckpointError,
    cache_state,
    gc_checkpoints,
    latest_step,
    latest_valid_step,
    restore_cache,
    restore_checkpoint,
    save_cache,
    save_checkpoint,
    verify_checkpoint,
)
from repro_torch.ckpt.recovery import LoopConfig, ResilientLoop
from repro_torch.configs import ARCHS
from repro_torch.control import DecisionJournal, load_journal, replay_rows
from repro_torch.control.restore import _REL_TOL, resolve_restored_ctrl
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import params_from_numpy
from repro_torch.serve import serve_step as tserve
from repro_torch.tune.table import save_table
from test_torch_obs import pin_watchdogs


def make_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((16, 32), generator=g),
            "b16": torch.randn((8, 8), generator=g).to(torch.bfloat16),
            "nested": {"v": torch.arange(10, dtype=torch.int32)},
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def struct_of(state):
    """A restore target of `state`'s structure holding nothing (the
    counterpart of `jax.eval_shape`)."""
    if isinstance(state, dict):
        return {k: struct_of(v) for k, v in state.items()}
    return torch.empty(state.shape, dtype=state.dtype, device="meta")


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict, with the checkpoint's paths."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def bits(x) -> np.ndarray:
    """A leaf of either package as comparable numpy bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def assert_trees_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert set(la) == set(lb)
    for key in la:
        assert dtype_name(la[key]) == dtype_name(lb[key]), key
        assert tuple(la[key].shape) == tuple(lb[key].shape), key
        np.testing.assert_array_equal(bits(la[key]), bits(lb[key]),
                                      err_msg=key)


def to_jax(tree):
    """The same values as the reference's arrays."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(bits(tree)).view(jnp.bfloat16)
    return jnp.asarray(bits(tree))


def manifest(d, step):
    return json.loads((d / f"step_{step:06d}" / "manifest.json").read_text())


def npz_keys(d, step):
    with np.load(d / f"step_{step:06d}" / "host_00000.npz") as z:
        return set(z.files)


# --------------------------------------- the reference's checkpoint tests

def test_roundtrip_exact(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 3, state)
    assert latest_step(tmp_path) == 3
    out = restore_checkpoint(tmp_path, 3, struct_of(make_state()))
    assert_trees_bitwise(state, out)
    assert manifest(tmp_path, 3)["leaves"]["params/b16"] == {
        "shape": [8, 8], "dtype": "bfloat16"}
    # the on-disk layout: sidecar, marker, no staging directory left
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_000003", "step_000003.COMPLETE"]
    assert sorted(p.name for p in (tmp_path / "step_000003").iterdir()) == [
        "host_00000.npz", "host_00000.npz.sha256", "manifest.json"]


def test_incomplete_checkpoint_not_restorable(tmp_path):
    save_checkpoint(tmp_path, 5, make_state())
    step_dir = tmp_path / "step_000009"  # a torn save: no COMPLETE marker
    step_dir.mkdir()
    (step_dir / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 5


def test_gc_keeps_latest(tmp_path):
    state = make_state()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, state)
    gc_checkpoints(tmp_path, keep=2)
    assert latest_step(tmp_path) == 5
    assert not (tmp_path / "step_000001").exists()
    assert (tmp_path / "step_000004").exists()


def test_async_checkpointer_copies_before_returning(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    state = make_state()
    want = {k: v.clone() for k, v in leaves(state).items()}
    ck.save(1, state)
    # the live buffers move on at once: the save holds the values it got
    for t in leaves(state).values():
        t.zero_()
    ck.wait()
    assert latest_step(tmp_path) == 1
    out = restore_checkpoint(tmp_path, 1, struct_of(make_state()))
    for key, t in leaves(out).items():
        assert torch.equal(t, want[key]), key


def test_multihost_manifest_merge(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 1, state, host_id=0, n_hosts=2)
    assert latest_step(tmp_path) is None  # not complete until host 1 lands
    save_checkpoint(tmp_path, 1, state, host_id=1, n_hosts=2)
    assert latest_step(tmp_path) == 1
    out = restore_checkpoint(tmp_path, 1, struct_of(make_state()))
    assert_trees_bitwise(state, out)


def test_resilient_loop_recovers_from_injected_faults(tmp_path):
    calls = {"fails": 0}

    def fail_injector(step):
        if step == 7 and calls["fails"] < 2:
            calls["fails"] += 1
            raise RuntimeError("injected device failure")

    loop = ResilientLoop(
        lambda s, b: ({"x": s["x"] + b}, {"loss": 0.0}),
        lambda step: torch.tensor(float(step)),
        LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_retries=3),
    )
    state = loop.run({"x": torch.tensor(0.0)}, 0, 10,
                     fail_injector=fail_injector)
    assert calls["fails"] == 2
    assert float(state["x"]) == sum(range(10))


def test_corrupt_checkpoint_detected_and_walked_past(tmp_path):
    from repro_torch.guard.inject import FaultInjector

    state = make_state()
    save_checkpoint(tmp_path, 1, state)
    save_checkpoint(tmp_path, 2, state)
    FaultInjector("corrupt-ckpt").corrupt_checkpoint(tmp_path)
    struct = struct_of(make_state())
    with pytest.raises(CorruptCheckpointError, match="sha256 mismatch"):
        restore_checkpoint(tmp_path, 2, struct)
    assert latest_step(tmp_path) == 2        # the marker still lies
    assert latest_valid_step(tmp_path) == 1  # the hashes don't
    assert_trees_bitwise(state, restore_checkpoint(tmp_path, 1, struct))
    loop = ResilientLoop(lambda s, b: (s, {}), lambda s: None,
                         LoopConfig(ckpt_dir=str(tmp_path)))
    resumed, start = loop.resume_or_init(make_state)
    assert start == 2
    assert_trees_bitwise(state, resumed)


def test_missing_manifest_behind_marker_is_corrupt(tmp_path):
    save_checkpoint(tmp_path, 3, make_state())
    (tmp_path / "step_000003" / "manifest.json").unlink()
    with pytest.raises(CorruptCheckpointError, match="manifest.json missing"):
        restore_checkpoint(tmp_path, 3, struct_of(make_state()))
    assert latest_valid_step(tmp_path) is None


def test_preemption_saves_final_checkpoint_and_resumes(tmp_path):
    def step_fn(state, batch):
        if int(state["x"]) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"x": state["x"] + 1.0}, {}

    cfg = LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=1000)
    state = ResilientLoop(step_fn, lambda s: None, cfg).run(
        {"x": torch.tensor(0.0)}, 0, 10)
    assert float(state["x"]) == 4.0
    assert latest_valid_step(tmp_path) == 3
    loop2 = ResilientLoop(step_fn, lambda s: None, cfg)
    resumed, start = loop2.resume_or_init(lambda: {"x": torch.tensor(0.0)})
    assert start == 4 and float(resumed["x"]) == 4.0
    assert float(loop2.run(resumed, start, 6)["x"]) == 10.0


def test_straggler_watchdog_flags_slow_steps(tmp_path):
    times = iter([0.01] * 10 + [0.2] + [0.01] * 5)

    def step_fn(state, batch):
        time.sleep(next(times))
        return state, {}

    loop = ResilientLoop(
        step_fn, lambda s: None,
        LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                   straggler_factor=3.0))
    loop.run({}, 0, 16)
    assert len(loop.straggler_events) >= 1
    assert loop.straggler_events[0]["action"].startswith("recommend")


# ------------------------------------------------ both packages, one disk

def qwen3_caches(tmp_path):
    """The port's reduced-qwen3 reuse cache after a prefill and 3 decode
    steps on the reference's weights (one site pinned to basic on layer 1,
    so a mode lane is not the default), and the reference engine's fresh
    cache of the same sites as the restore target."""
    jcfg, tcfg = JARCHS["qwen3-32b"].reduced(), ARCHS["qwen3-32b"].reduced()
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, "cpu")
    eng = tserve.build_reuse_engine(tcfg, impl="cuda")
    rc = eng.init_cache(2, device="cpu")
    eng.set_mode(rc, "mlp_out", "basic", layer=1)
    state = tserve.init_serve_state(tcfg, 2, 16, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 4))
    logits, state = tserve.prefill_step(
        params, tcfg, torch.from_numpy(prompts.astype(np.int32)), state)
    for _ in range(3):
        tok = tserve.greedy_sample(logits[:, -1:])
        logits, state, rc = tserve.decode_step(params, tcfg, tok, state,
                                               engine=eng, reuse_cache=rc)
    jeng = jserve.build_reuse_engine(jcfg, impl="jnp")
    return eng, rc, jeng, jeng.init_cache(2)


def sharded_caches():
    """Reduced qwen3's caches after `shard_sites(2)` in both packages, the
    port's filled from a seed (every leaf, in its dtype)."""
    jcfg, tcfg = JARCHS["qwen3-32b"].reduced(), ARCHS["qwen3-32b"].reduced()
    eng = tserve.build_reuse_engine(tcfg, impl="cuda")
    eng.shard_sites(2)
    rc = eng.init_cache(2, device="cpu")
    rng = np.random.default_rng(1)
    for t in leaves(cache_state(rc)).values():
        if t.dtype.is_floating_point:
            t.copy_(torch.from_numpy(rng.normal(size=t.shape)))
        else:
            t.copy_(torch.from_numpy(rng.integers(-100, 100, t.shape)))
    jeng = jserve.build_reuse_engine(jcfg, impl="jnp")
    jeng.shard_sites(2)
    return eng, rc, jeng, jeng.init_cache(2)


@pytest.mark.parametrize("what", ["state", "qwen3_cache", "sharded_cache"])
def test_port_checkpoint_restores_in_reference_and_back(tmp_path, what):
    """A port save restored by `repro.ckpt.restore_checkpoint`, and the
    reference's save of the same values restored by the port: leaves
    bitwise, manifest leaves and npz keys equal."""
    if what == "state":
        state = make_state()
        live = struct_of(state)
        jstruct = jax.eval_shape(lambda: to_jax(state))
    else:
        eng, rc, jeng, jrc = (qwen3_caches(tmp_path) if what == "qwen3_cache"
                              else sharded_caches())
        state = cache_state(rc)
        jstruct = jrc
        live = eng.init_cache(2, device="cpu")
        if what == "sharded_cache":
            L, S, B, N = state["mlp_in"]["prev_out"].shape
            assert (S, N) == (2, eng.sites["mlp_in"].out_features // 2)
            assert jrc["mlp_in"]["prev_out"].shape == (L, S, B, N)
    save_checkpoint(tmp_path / "port", 4, state)
    got = jck.restore_checkpoint(tmp_path / "port", 4, jstruct)
    assert_trees_bitwise(state, got)
    jck.save_checkpoint(tmp_path / "ref", 4, to_jax(state))
    assert manifest(tmp_path / "ref", 4)["leaves"] == manifest(
        tmp_path / "port", 4)["leaves"]
    assert npz_keys(tmp_path / "ref", 4) == npz_keys(tmp_path / "port", 4)
    if what == "state":
        live = restore_checkpoint(tmp_path / "ref", 4, live)
    else:
        live = cache_state(restore_cache(tmp_path / "ref", 4, live))
    assert_trees_bitwise(state, live)


def test_restore_into_live_cache_keeps_addresses_and_rebuilds_mode_host(
        tmp_path):
    eng, rc, _, _ = qwen3_caches(tmp_path)
    save_cache(tmp_path, 3, rc)
    fresh = eng.init_cache(2, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in leaves(cache_state(fresh)).items()}
    mirrors = {n: e["mode_host"] for n, e in fresh.items()}
    assert not np.array_equal(fresh["mlp_out"]["mode_host"],
                              rc["mlp_out"]["mode_host"])
    restore_cache(tmp_path, 3, fresh)
    assert {k: t.data_ptr()
            for k, t in leaves(cache_state(fresh)).items()} == ptrs
    assert_trees_bitwise(cache_state(rc), cache_state(fresh))
    for name, entry in fresh.items():
        assert entry["mode_host"] is mirrors[name]
        np.testing.assert_array_equal(entry["mode_host"],
                                      entry["ctrl"]["mode_id"].numpy())
        np.testing.assert_array_equal(entry["mode_host"],
                                      rc[name]["mode_host"])
    assert "mode_host" not in json.dumps(manifest(tmp_path, 3)["leaves"])
    # a leaf of another shape is refused before anything is written
    other = eng.init_cache(3, device="cpu")
    with pytest.raises(ValueError, match="in the checkpoint"):
        restore_cache(tmp_path, 3, other)
    assert not other["attn_qkv"]["steps"].any()


def _damage(d, kind):
    step_dir = d / "step_000002"
    host = step_dir / "host_00000.npz"
    if kind == "flipped":
        data = bytearray(host.read_bytes())
        data[len(data) // 2] ^= 0xFF
        host.write_bytes(bytes(data))
    elif kind == "no_manifest":
        (step_dir / "manifest.json").unlink()
    elif kind == "bad_manifest":
        (step_dir / "manifest.json").write_text("{not json")
    elif kind == "no_host_file":
        host.unlink()
    elif kind == "unreadable_unhashed":
        # a checkpoint without hashes whose payload is not a zip
        m = json.loads((step_dir / "manifest.json").read_text())
        m.pop("files")
        (step_dir / "manifest.json").write_text(json.dumps(m))
        (step_dir / "host_00000.npz.sha256").unlink()
        host.write_bytes(b"not a zip archive")


@pytest.mark.parametrize("kind", ["flipped", "no_manifest", "bad_manifest",
                                  "no_host_file", "unreadable_unhashed"])
def test_both_packages_refuse_the_same_damage(tmp_path, kind):
    state = make_state()
    for pkg in ("port", "ref"):
        save_checkpoint(tmp_path / pkg, 1, state)
        save_checkpoint(tmp_path / pkg, 2, state)
        _damage(tmp_path / pkg, kind)
    errors = {}
    for pkg, restore, err in (
            ("port", lambda d: restore_checkpoint(d, 2, struct_of(state)),
             CorruptCheckpointError),
            ("ref", lambda d: jck.restore_checkpoint(
                d, 2, jax.eval_shape(lambda: to_jax(state))),
             jck.CorruptCheckpointError)):
        with pytest.raises(err) as e:
            restore(tmp_path / pkg)
        errors[pkg] = str(e.value).replace(str(tmp_path / pkg), "D")
        assert jck.latest_valid_step(tmp_path / pkg) == (
            2 if kind == "unreadable_unhashed" else 1)
        assert latest_valid_step(tmp_path / pkg) == jck.latest_valid_step(
            tmp_path / pkg)
    if kind == "unreadable_unhashed":  # the zip library's own words follow
        errors = {k: v.split(": unreadable payload")[0]
                  for k, v in errors.items()}
    else:
        with pytest.raises(CorruptCheckpointError):
            verify_checkpoint(tmp_path / "ref", 2)
    assert errors["port"] == errors["ref"]


# ------------------------------------------------------ restore precedence

def _drifted(pkg, table_rows, drift):
    """One engine of `pkg` with sites a, b (unstacked) and c (3 layers), a
    table of `table_rows`, and a fresh cache whose sim_threshold lanes are
    set to `drift` (as a restored checkpoint's would be)."""
    Engine, Policy, Tun = ((ReuseEngine, ReusePolicy, SiteTunables)
                           if pkg == "port" else (JEngine, JPolicy, JTunables))
    engine = Engine(policy=Policy(site_tunables={
        k: Tun(**v) for k, v in table_rows.items()}))
    engine.register("a", 64, 32, block_m=2, block_k=32)
    engine.register("b", 64, 32, block_m=2, block_k=32)
    engine.register("c", 64, 32, n_layers=3, block_m=2, block_k=32)
    if pkg == "port":
        cache = engine.init_cache(2, device="cpu")
        for name, thr in drift.items():
            cache[name]["ctrl"]["sim_threshold"].copy_(torch.tensor(thr))
    else:
        cache = engine.init_cache(2)
        for name, thr in drift.items():
            lane = cache[name]["ctrl"]["sim_threshold"]
            cache[name] = dict(cache[name], ctrl=dict(
                cache[name]["ctrl"],
                sim_threshold=jnp.broadcast_to(
                    jnp.asarray(thr, jnp.float32), lane.shape)))
    return engine, cache


PRECEDENCE = {
    "table_wins_uncovered_adopts": (
        {"a": dict(sim_threshold=0.4, min_work_flops=1e5),
         "c@1": dict(sim_threshold=0.6)},
        {"a": 0.9, "b": 0.77, "c": [0.9, 0.8, 0.77]}),
    "noop_when_checkpoint_matches": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_restore_precedence_matches_reference(tmp_path, case):
    table_rows, drift = PRECEDENCE[case]
    out = {}
    for pkg, resolve, Journal in (("port", resolve_restored_ctrl,
                                   DecisionJournal),
                                  ("ref", jresolve, JJournal)):
        engine, cache = _drifted(pkg, table_rows, drift)
        path = tmp_path / f"{pkg}.jsonl"
        decisions = resolve(engine, cache, journal=Journal(str(path)),
                            step=0)
        lanes = {n: np.asarray(cache[n]["ctrl"]["sim_threshold"]).tolist()
                 for n in engine.sites}
        rows = ([{k: v for k, v in r.items() if k != "ts"}
                 for r in load_journal(str(path))] if path.exists() else [])
        out[pkg] = (decisions, lanes, rows, dict(engine.policy.site_tunables))
    (dp, lp, rp, tp), (dr, lr, rr, tr) = out["port"], out["ref"]
    assert [(d.site, d.layer, d.field, d.kind, d.reason) for d in dp] == [
        (d.site, d.layer, d.field, d.kind, d.reason) for d in dr]
    for a, b in zip(dp, dr):
        assert a.before == pytest.approx(b.before, rel=_REL_TOL)
        assert a.after == pytest.approx(b.after, rel=_REL_TOL)
    assert lp == pytest.approx(lr, rel=_REL_TOL)
    assert rp == rr
    assert sorted(tp) == sorted(tr)
    for key in tp:
        assert tp[key].to_dict() == pytest.approx(tr[key].to_dict())
    if case == "noop_when_checkpoint_matches":
        assert dp == [] and rp == [] and not tp
        return
    assert replay_rows(rp).ok
    # covered lanes take the table (a, c@1), uncovered ones adopt
    assert lp["a"] == pytest.approx(0.4)
    assert lp["b"] == pytest.approx(0.77)
    assert lp["c"] == pytest.approx([0.9, 0.6, 0.77])
    assert {k for k in tp} == {"a", "b", "c@0", "c@1", "c@2"}


def test_restore_precedence_on_a_sharded_cache(tmp_path):
    """A sharded site's ctrl lanes are replicated over the shard axis
    ([L, S], [S] unstacked): the port resolves them as the reference
    resolves the unsharded cache, and writes every shard's lane. (The
    reference's own pass cannot read them: `float()` of a length-S row
    raises.)"""
    table_rows, drift = PRECEDENCE["table_wins_uncovered_adopts"]
    engine, cache = _drifted("port", table_rows, {})
    engine.shard_sites(2)
    cache = engine.init_cache(2, device="cpu")
    for name, thr in drift.items():
        lane = cache[name]["ctrl"]["sim_threshold"]
        lane.copy_(torch.tensor(thr).reshape(-1, 1).expand(lane.shape)
                   if lane.dim() == 2 else torch.tensor(thr).expand(lane.shape))
    got = resolve_restored_ctrl(engine, cache, step=0)
    jengine, jcache = _drifted("ref", table_rows, drift)
    want = jresolve(jengine, jcache, step=0)
    # the same f32 lane values, read on both sides as doubles
    assert [(d.site, d.layer, d.field, d.before, d.after) for d in got] == [
        (d.site, d.layer, d.field, d.before, d.after) for d in want]
    assert got
    assert cache["c"]["ctrl"]["sim_threshold"].shape == (3, 2)
    assert cache["c"]["ctrl"]["sim_threshold"][:, 1].tolist() == \
        pytest.approx([0.9, 0.6, 0.77])
    assert cache["a"]["ctrl"]["sim_threshold"].tolist() == \
        pytest.approx([0.4, 0.4])


# ------------------------------------------------- serve --cache-ckpt

SERVE = ["--arch", "qwen3-32b", "--reduced", "--requests", "2",
         "--batch-slots", "2", "--max-new", "6", "--reuse",
         "--control-every", "2"]


@pytest.fixture(scope="module")
def ckpt_serves(tmp_path_factory):
    """Reduced qwen3 with a table pinning attn_qkv's sim_threshold: each
    package's serve saves (`--cache-ckpt`), then each restores the other's
    checkpoint without the table (the port's restore run also arms
    `--inject corrupt-ckpt`, which corrupts what it saves at exit). The
    reference's engine runs at impl="pallas" and the port takes its weights,
    as in the other serve parity tests; both watchdogs are pinned."""
    from repro.launch import serve as jserve_cli

    d = tmp_path_factory.mktemp("ckpt_serves")
    table = str(d / "table.json")
    save_table(table, {"attn_qkv": SiteTunables(sim_threshold=0.61)})
    mp = pytest.MonkeyPatch()
    pin_watchdogs(mp)
    build = jserve_cli.build_reuse_engine
    mp.setattr(jserve_cli, "build_reuse_engine",
               lambda cfg, *, impl="jnp", policy=None: build(
                   cfg, impl="pallas", policy=policy))
    tree = jax.tree.map(np.asarray, jinit_params(
        JARCHS["qwen3-32b"].reduced(), jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, ARCHS["qwen3-32b"].reduced(), "cpu")
    mp.setattr(tserve_cli, "init_params", lambda cfg, seed, device: params)

    def ref(name, extra):
        mp.setattr(sys, "argv", ["serve", *SERVE, *extra,
                                 "--control-journal", str(d / f"{name}.jsonl")])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jserve_cli.main()
        return buf.getvalue()

    def port(name, extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tserve_cli.run(
                ARCHS["qwen3-32b"].reduced(),
                tserve_cli.build_parser().parse_args(
                    SERVE + extra + ["--device", "cpu", "--control-journal",
                                     str(d / f"{name}.jsonl")]))
        return buf.getvalue(), res

    out = {"dir": d}
    out["ref_save"] = ref("ref_save", ["--tuned-policy", table,
                                       "--cache-ckpt", str(d / "R")])
    out["port_save"], res = port("port_save", [
        "--tuned-policy", table, "--cache-ckpt", str(d / "P")])
    out["port_save_cache"] = {k: v.clone() for k, v in
                              leaves(cache_state(res["rcache"])).items()}
    out["manifests"] = {k: manifest(d / k, 5) for k in "RP"}
    out["keys"] = {k: npz_keys(d / k, 5) for k in "RP"}
    out["port_restore_cache"] = jck.restore_checkpoint(
        d / "P", 5, jax.tree.map(lambda x: x, cache_state(res["rcache"])))
    out["ref_restore"] = ref("ref_restore", ["--cache-ckpt", str(d / "P")])
    out["port_restore"], _ = port("port_restore", [
        "--cache-ckpt", str(d / "R"), "--inject", "corrupt-ckpt"])
    mp.undo()
    return out


def _ckpt_lines(text, d):
    return [ln.replace(str(d), "D") for ln in text.splitlines()
            if ln.startswith(("cache checkpoint:", "  restore "))]


def test_serve_saves_the_reference_checkpoint(ckpt_serves):
    s = ckpt_serves
    d = s["dir"]
    assert _ckpt_lines(s["port_save"], d / "P") == _ckpt_lines(
        s["ref_save"], d / "R") == ["cache checkpoint: saved step 5 to D"]
    mr, mp_ = s["manifests"]["R"], s["manifests"]["P"]
    assert mr["leaves"] == mp_["leaves"]
    assert (mr["step"], mr["n_hosts"]) == (mp_["step"], mp_["n_hosts"])
    assert s["keys"]["R"] == s["keys"]["P"]
    assert not any("mode_host" in k for k in s["keys"]["P"])
    # the reference reads the port's checkpoint back bitwise
    for key, want in s["port_save_cache"].items():
        got = leaves(s["port_restore_cache"])[key]
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=key)


def test_serve_restores_the_other_packages_checkpoint(ckpt_serves):
    s = ckpt_serves
    d = s["dir"]
    port = _ckpt_lines(s["port_restore"], d / "R")
    ref = _ckpt_lines(s["ref_restore"], d / "P")
    assert port == ref
    n_layers = ARCHS["qwen3-32b"].reduced().n_layers
    assert port[0] == (
        f"cache checkpoint: restored step 5 from D; ctrl precedence resolved "
        f"{n_layers} lanes (checkpoint < tuned table < live)")
    assert port[1:-1] == [f"  restore attn_qkv@{i} sim_threshold: "
                          f"{port[1].split(': ')[1].split(' -> ')[0]} -> "
                          f"{np.float32(0.61).item()}"
                          for i in range(n_layers)]
    rows = {}
    for name in ("port_restore", "ref_restore"):
        rows[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in load_journal(str(d / f"{name}.jsonl"))
                      if r.get("decision_kind") == "restore"]
    assert rows["port_restore"] == rows["ref_restore"]
    assert len(rows["port_restore"]) == n_layers
    assert replay_rows(rows["port_restore"]).ok


def test_serve_corrupted_checkpoint_stops_the_next_start(ckpt_serves,
                                                        monkeypatch):
    """The port's restore run corrupted its save at exit; the next start of
    either package raises CorruptCheckpointError before serving."""
    from repro.launch import serve as jserve_cli

    s = ckpt_serves
    d = s["dir"]
    assert "corrupt-ckpt @step -1: flipped 64 bytes mid-file in " \
        f"{d / 'R' / 'step_000005' / 'host_00000.npz'}" in s["port_restore"]
    args = tserve_cli.build_parser().parse_args(
        SERVE + ["--cache-ckpt", str(d / "R"), "--device", "cpu"])
    with pytest.raises(CorruptCheckpointError, match="sha256 mismatch"):
        tserve_cli.run(ARCHS["qwen3-32b"].reduced(), args)
    monkeypatch.setattr(sys, "argv",
                        ["serve", *SERVE, "--cache-ckpt", str(d / "R")])
    with pytest.raises(jck.CorruptCheckpointError, match="sha256 mismatch"):
        jserve_cli.main()
    assert latest_valid_step(d / "R") is None


def test_serve_cache_ckpt_requires_reuse():
    args = tserve_cli.build_parser().parse_args(
        ["--arch", "qwen3-32b", "--reduced", "--cache-ckpt", "D",
         "--device", "cpu"])
    with pytest.raises(ValueError, match="--cache-ckpt requires --reuse"):
        tserve_cli.run(ARCHS["qwen3-32b"].reduced(), args)



def test_ckpt_exports_match_the_reference():
    from repro import ckpt as jckpt
    from repro_torch import ckpt

    assert ckpt.__all__ == jckpt.__all__


def test_serve_sharded_cache_round_trip(tmp_path, monkeypatch):
    """`--mesh host:2 --cache-ckpt`: the save keeps the [L, S, ...] layout
    (prev_out [L, 2, B, N/2]), and a host:2 serve restores it in place:
    its cache before the first step is the checkpoint, in the tensors
    init_cache built."""
    argv = ["--arch", "qwen3-32b", "--reduced", "--requests", "2",
            "--batch-slots", "2", "--max-new", "3", "--reuse", "--mesh",
            "host:2", "--device", "cpu", "--cache-ckpt", str(tmp_path / "S")]
    cfg = ARCHS["qwen3-32b"].reduced()
    res = tserve_cli.run(cfg, tserve_cli.build_parser().parse_args(argv))
    n = res["stats"]["steps"]
    saved = {k: v.clone() for k, v in leaves(cache_state(res["rcache"])).items()}
    shape = manifest(tmp_path / "S", n)["leaves"]["mlp_in/prev_out"]["shape"]
    assert shape == [cfg.n_layers, 2, 2,
                     res["engine"].sites["mlp_in"].out_features // 2]
    seen = {}
    init_cache = ReuseEngine.init_cache

    def recording_init(self, batch, **kw):
        cache = init_cache(self, batch, **kw)
        seen["ptrs"] = {k: t.data_ptr()
                        for k, t in leaves(cache_state(cache)).items()}
        return cache

    def recording_step(*args, rcache, **kw):
        seen["at_build"] = {k: (t.clone(), t.data_ptr())
                            for k, t in leaves(cache_state(rcache)).items()}
        return step_cls(*args, rcache=rcache, **kw)

    step_cls = tserve_cli.CompiledStep
    monkeypatch.setattr(ReuseEngine, "init_cache", recording_init)
    monkeypatch.setattr(tserve_cli, "CompiledStep", recording_step)
    tserve_cli.run(cfg, tserve_cli.build_parser().parse_args(argv))
    for key, (t, ptr) in seen["at_build"].items():
        assert torch.equal(t, saved[key]), key
        assert ptr == seen["ptrs"][key], key
