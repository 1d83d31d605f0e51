"""The port's sharded reuse serving (`serve --mesh`, `repro_torch.dist`,
`repro_torch.launch.mesh`) against the reference's (`repro.dist`,
`repro.launch.mesh`), on the CPU.

The reference's own cases (`tests/test_shard.py`) run on the port: sharding
is a layout, never a semantics change, so the shards' counters summed are
the unsharded counters and the outputs the unsharded outputs, bitwise, on
every exec path; the snapshot is the cross-mesh reduce and meters its
payload; spec and divisibility errors; journal v5 and replay per shard.
Then the same numpy-seeded streams go through both packages' sharded
engines (`eng.shard_sites(S)` runs without a mesh in both): every counter
lane of every shard bitwise, and the outputs bitwise on integer-valued
operands; on float operands the outputs are the same f32 products summed
in another order (torch's CPU matmul against XLA's dot), held to atol 1e-5
+ rtol 1e-5 as `tests/test_torch_kernels.py` holds them.

Last, `serve --mesh host:2 --control-every 2 --control-journal` on reduced
qwen3 and reduced mixtral in both packages: the reference's in one
module-scoped subprocess with `XLA_FLAGS=--xla_force_host_platform_device_
count=2` (the flag must be set before JAX initialises), its engine at
impl="pallas" and its straggler watchdog pinned, and with its mesh built
with the `Auto` axis type: the JAX in this environment makes `Explicit`
axes by default, under which the reference's sharded step does not lower.
The port is given the reference's weights. Journals row for row, and the
`mesh:`, `shard skip` and `ici traffic` lines, must match.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.engine import ReuseEngine as JEngine
from repro.models import init_params as jinit_params
from repro.serve import serve_step as jserve
from repro.sensor.counters import COUNTER_SHARD_REDUCE as JREDUCE
from repro_torch.configs import ARCHS
from repro_torch.core.engine import ReuseEngine
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import params_from_numpy
from repro_torch.sensor.counters import COUNTER_SHARD_REDUCE
from repro_torch.serve import serve_step as tserve

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
STEP_TOL = 1e-4
PATHS = ("dense", "compact", "kernel", "ragged")


def t2n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def collapse(sensor, axis=0):
    """Sum or first per counter over the shard axis (the mesh reduce)."""
    return {key: (t2n(v).sum(axis=axis)
                  if COUNTER_SHARD_REDUCE.get(key, "first") == "sum"
                  else np.take(t2n(v), 0, axis=axis))
            for key, v in sensor.items()}


def stream(seed, steps, b, k, skip, integer):
    """The inputs of a similarity-controlled stream: each step keeps an
    element with probability `skip`."""
    rng = np.random.default_rng(seed)
    draw = ((lambda shape: rng.integers(-2, 3, size=shape).astype(np.float32))
            if integer else
            (lambda shape: rng.normal(size=shape).astype(np.float32)))
    w = draw((k, 128)) if integer else draw((k, 128)) * 0.1
    x = draw((b, k))
    xs = []
    for _ in range(steps):
        keep = rng.random((b, k)) < skip
        x = np.where(keep, x, draw((b, k)))
        xs.append(x)
    return w, xs


def build(pkg, n_shards, exec_path, *, k=256, n=128, bm=4, bk=32, b=2,
          n_layers=0, integer=False):
    """One site registered in the port's ("port") or the reference's
    ("ref") engine, sharded `n_shards`-ways (1: unsharded)."""
    scale = {"fixed_scale": 1.0} if integer else {}
    if pkg == "port":
        eng = ReuseEngine(impl="torch")
    else:
        eng = JEngine(impl="jnp")
    eng.register("site", k, n, block_m=bm, block_k=bk, n_layers=n_layers)
    eng.sites["site"] = dataclasses.replace(
        eng.sites["site"], **scale,
        **({} if exec_path == "auto" else {"exec_path": exec_path}))
    if n_shards > 1:
        eng.shard_sites(n_shards)
    cache = (eng.init_cache(b, device="cpu") if pkg == "port"
             else eng.init_cache(b))
    return eng, cache


def run_stream(pkg, n_shards, exec_path, skip, seed, *, steps=4, b=2, k=256,
               integer=False):
    """A stream through one site; returns (outputs, entry, engine)."""
    eng, cache = build(pkg, n_shards, exec_path, k=k, b=b, integer=integer)
    entry = cache["site"]
    w, xs = stream(seed, steps, b, k, skip, integer)
    outs = []
    for x in xs:
        if pkg == "port":
            out, entry, _ = eng.apply("site", torch.from_numpy(x),
                                      torch.from_numpy(w), None, entry)
        else:
            out, entry, _ = eng.apply("site", jnp.asarray(x), jnp.asarray(w),
                                      None, entry)
        outs.append(t2n(out).copy())
    return outs, entry, eng


def assert_shard_parity(exec_path, skip, n_shards, seed):
    """The shards' counters summed are the unsharded counters, and the
    outputs the unsharded outputs, bitwise."""
    outs_1, entry_1, _ = run_stream("port", 1, exec_path, skip, seed)
    outs_s, entry_s, _ = run_stream("port", n_shards, exec_path, skip, seed)
    for a, c in zip(outs_1, outs_s):
        np.testing.assert_array_equal(a, c)
    got = collapse(entry_s["sensor"])
    for key, want in entry_1["sensor"].items():
        np.testing.assert_array_equal(got[key], t2n(want), err_msg=key)


# ------------------------------------------------ the central shard property

@pytest.mark.parametrize("skip", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("exec_path", PATHS)
def test_shard_sum_is_unsharded_bitwise(skip, exec_path):
    """Every exec path × skip regime at 4-way sharding (the reference
    holds dense and compact here and kernel and ragged at one point)."""
    assert_shard_parity(exec_path, skip, 4, seed=1)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_shard_parity_at_other_widths(n_shards):
    assert_shard_parity("kernel", 0.5, n_shards, seed=7)


def test_counter_reduce_table_is_the_references():
    assert COUNTER_SHARD_REDUCE == JREDUCE


@pytest.mark.parametrize("exec_path", PATHS)
@pytest.mark.parametrize("integer", [False, True])
def test_sharded_engine_matches_reference(exec_path, integer):
    """The same stream through both packages' 4-way sharded engines: every
    shard's counter lane bitwise, prev_q and the ctrl lanes bitwise; the
    outputs and prev_out bitwise on integer-valued operands, within the
    module's f32 tolerance on float ones."""
    outs_t, entry_t, _ = run_stream("port", 4, exec_path, 0.5, 3,
                                    integer=integer)
    outs_j, entry_j, _ = run_stream("ref", 4, exec_path, 0.5, 3,
                                    integer=integer)
    for got, want in zip(outs_t, outs_j):
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for key, want in entry_j["sensor"].items():
        np.testing.assert_array_equal(t2n(entry_t["sensor"][key]),
                                      np.asarray(want), err_msg=key)
    np.testing.assert_array_equal(t2n(entry_t["prev_q"]),
                                  np.asarray(entry_j["prev_q"]))
    for key, want in entry_j["ctrl"].items():
        np.testing.assert_array_equal(t2n(entry_t["ctrl"][key]),
                                      np.asarray(want), err_msg=key)
    (np.testing.assert_array_equal if integer else
     lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL))(
        t2n(entry_t["prev_out"]), np.asarray(entry_j["prev_out"]))


def test_stacked_site_shard_parity_and_reference():
    """A stacked site's shard axis sits inside the layer axis ([L, S, ...]):
    the layer loop takes views of lane l, the shard evaluation views of
    lane s; the bitwise invariant holds per layer, and the counters equal
    the reference's stacked sharded engine's, lane for lane."""
    b, k, n, n_layers = 2, 256, 128, 2

    def run(pkg, n_shards):
        rng = np.random.default_rng(3)
        eng, cache = build(pkg, n_shards, "dense", k=k, n=n, b=b,
                           n_layers=n_layers)
        entry = cache["site"]
        ws = [rng.normal(size=(k, n)).astype(np.float32) * 0.1
              for _ in range(n_layers)]
        x = rng.normal(size=(b, k)).astype(np.float32)
        outs = []
        for _ in range(4):
            keep = rng.random((b, k)) < 0.5
            x = np.where(keep, x, rng.normal(size=(b, k)).astype(np.float32))
            for layer in range(n_layers):
                if pkg == "port":
                    view = eng.layer_view({"site": entry}, layer)["site"]
                    out, _, _ = eng.apply("site", torch.from_numpy(x),
                                          torch.from_numpy(ws[layer]), None,
                                          view)
                else:
                    lentry = jax.tree.map(lambda a, l=layer: a[l], entry)
                    out, lentry, _ = eng.apply("site", jnp.asarray(x),
                                               jnp.asarray(ws[layer]), None,
                                               lentry)
                    entry = jax.tree.map(
                        lambda full, part, l=layer: full.at[l].set(part),
                        entry, lentry)
                outs.append(t2n(out).copy())
        return outs, entry

    outs_1, entry_1 = run("port", 1)
    outs_2, entry_2 = run("port", 2)
    for a, c in zip(outs_1, outs_2):
        np.testing.assert_array_equal(a, c)
    got = collapse(entry_2["sensor"], axis=1)
    for key, want in entry_1["sensor"].items():
        np.testing.assert_array_equal(got[key], t2n(want), err_msg=key)
    _, entry_j = run("ref", 2)
    assert tuple(entry_2["prev_out"].shape) == entry_j["prev_out"].shape
    for key, want in entry_j["sensor"].items():
        np.testing.assert_array_equal(t2n(entry_2["sensor"][key]),
                                      np.asarray(want), err_msg=key)


def test_snapshot_reduce_and_ici_metering():
    """The ctrl snapshot's sums are the cross-mesh reduce: global skipped/
    computed equal the unsharded snapshot's, the [S] lanes ride along, and
    the payload is metered into ici_reduce_bytes exactly as the reference
    meters it (unsharded engines meter nothing)."""
    _, entry_1, eng_1 = run_stream("port", 1, "dense", 0.5, 5)
    _, entry_4, eng_4 = run_stream("port", 4, "dense", 0.5, 5)
    _, entry_j, eng_j = run_stream("ref", 4, "dense", 0.5, 5)
    snap_1 = eng_1.ctrl_snapshot({"site": entry_1})
    snap_4 = eng_4.ctrl_snapshot({"site": entry_4})
    snap_j = eng_j.ctrl_snapshot({"site": entry_j})
    assert snap_1["site"]["skipped"] == snap_4["site"]["skipped"]
    assert snap_1["site"]["computed"] == snap_4["site"]["computed"]
    for key in ("skipped_shard", "computed_shard"):
        assert snap_4["site"][key].shape == (4,)
        np.testing.assert_array_equal(snap_4["site"][key],
                                      np.asarray(snap_j["site"][key]))
    assert int(snap_4["site"]["skipped_shard"].sum()) == \
        snap_4["site"]["skipped"]
    for key in ("sim_l", "mode_id", "sim_threshold", "min_work",
                "cooldown"):
        np.testing.assert_array_equal(snap_4["site"][key],
                                      np.asarray(snap_j["site"][key]))
    assert "skipped_shard" not in snap_1["site"]
    assert eng_1.ici_reduce_bytes == 0.0
    assert eng_4.ici_reduce_bytes == eng_j.ici_reduce_bytes > 0.0


def test_sentinel_lanes_combine_across_shards():
    """The breaker's snapshot on a sharded site: a NaN in one shard's
    prev_out lane and a garbage mode id in another's show in the combined
    lanes (bad_out summed, ctrl_bad OR-ed), as in the reference's."""
    _, entry_t, eng_t = run_stream("port", 4, "dense", 0.5, 5)
    _, entry_j, eng_j = run_stream("ref", 4, "dense", 0.5, 5)
    entry_t["prev_out"][1, 0, 3] = float("nan")
    entry_t["ctrl"]["mode_id"][2] = 7
    entry_t["ctrl"]["cooldown"][3] = -1
    entry_j = dict(entry_j,
                   prev_out=entry_j["prev_out"].at[1, 0, 3].set(jnp.nan),
                   ctrl=dict(entry_j["ctrl"],
                             mode_id=entry_j["ctrl"]["mode_id"].at[2].set(7),
                             cooldown=entry_j["ctrl"]["cooldown"]
                             .at[3].set(-1)))
    got = eng_t.ctrl_snapshot({"site": entry_t}, sentinels=True)["site"]
    want = eng_j.ctrl_snapshot({"site": entry_j})["site"]
    for key in ("bad_out", "bad_sim", "ctrl_bad", "quarantine", "skipped_l",
                "computed_l", "steps_l"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    assert int(got["bad_out"][0]) == 1 and int(got["ctrl_bad"][0]) == 1 | 2


def test_ctrl_writes_reach_every_shard_in_place():
    """Mode refreshes, tunables and a quarantine write every shard's lane
    of the ctrl block in place (the data pointers stay: a captured graph
    reads them), and the fan-out is metered as the reference meters it."""
    from repro.core.policy import SiteTunables as JTunables
    from repro_torch.core.policy import SiteTunables
    from repro_torch.guard import QuarantineBreaker

    _, entry_t, eng_t = run_stream("port", 4, "dense", 0.5, 5)
    _, entry_j, eng_j = run_stream("ref", 4, "dense", 0.5, 5)
    cache_t, cache_j = {"site": entry_t}, {"site": entry_j}
    ptrs = {k: v.data_ptr() for k, v in entry_t["ctrl"].items()}
    eng_t.apply_tunables("site", SiteTunables(sim_threshold=0.4), cache_t)
    eng_j.apply_tunables("site", JTunables(sim_threshold=0.4), cache_j)
    eng_t.refresh_modes(cache_t)
    eng_j.refresh_modes(cache_j)
    for key, want in cache_j["site"]["ctrl"].items():
        np.testing.assert_array_equal(t2n(entry_t["ctrl"][key]),
                                      np.asarray(want), err_msg=key)
    np.testing.assert_array_equal(entry_t["mode_host"],
                                  np.asarray(cache_j["site"]["ctrl"]
                                             ["mode_id"]))
    assert eng_t.ici_write_bytes == eng_j.ici_write_bytes > 0.0
    assert eng_t.ici_reduce_bytes == eng_j.ici_reduce_bytes
    QuarantineBreaker()._apply_quarantine(eng_t, cache_t, "site", None, 3)
    assert {k: v.data_ptr() for k, v in entry_t["ctrl"].items()} == ptrs
    assert (t2n(entry_t["ctrl"]["quarantine"]) == 3).all()
    assert (entry_t["mode_host"] == 0).all()
    assert (t2n(entry_t["prev_out"]) == 0).all()


def test_retune_snapshot_entry_collapses_shards():
    """snapshot_entry(shard_axis=) reads the sharded entry as the unsharded
    one (one transfer; the reference's collapse), equal to the reference's
    snapshot of its sharded entry."""
    from repro.control.retune import snapshot_entry as jsnapshot_entry
    from repro_torch.control.retune import snapshot_entry

    _, entry_1, _ = run_stream("port", 1, "kernel", 0.5, 9)
    _, entry_4, _ = run_stream("port", 4, "kernel", 0.5, 9)
    _, entry_j, _ = run_stream("ref", 4, "kernel", 0.5, 9)
    got = snapshot_entry(entry_4, shard_axis=0)
    base = snapshot_entry(entry_1)
    want = jsnapshot_entry(entry_j, shard_axis=0)
    assert set(got) == set(want) == set(base)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(base[key]), err_msg=key)


def test_shard_sites_validates_divisibility():
    eng = ReuseEngine(impl="torch")
    eng.register("site", 256, 100, block_m=4, block_k=32)
    jeng = JEngine(impl="jnp")
    jeng.register("site", 256, 100, block_m=4, block_k=32)
    with pytest.raises(ValueError) as got:
        eng.shard_sites(3)
    with pytest.raises(ValueError) as want:
        jeng.shard_sites(3)
    assert str(got.value) == str(want.value)
    assert "divisible" in str(got.value)


# ------------------------------------------------------- mesh spec parsing

@pytest.mark.parametrize("spec", ["ring:4", "host:abc", "host:8@x", "host:8@3",
                                  "host:0"])
def test_mesh_spec_errors_are_the_references(spec):
    from repro.launch.mesh import parse_mesh_spec as jparse
    from repro_torch.launch.mesh import parse_mesh_spec

    with pytest.raises(ValueError) as got:
        parse_mesh_spec(spec)
    with pytest.raises(ValueError) as want:
        jparse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,chips", [("prod", 256), ("prod-pod", 512)])
def test_production_mesh_raises_naming_what_it_needs(spec, chips):
    from repro_torch.launch.mesh import parse_mesh_spec

    with pytest.raises(NotImplementedError, match=f"{chips} cards"):
        parse_mesh_spec(spec)


def test_host_mesh_shapes():
    from repro_torch.launch.mesh import mesh_axes, parse_mesh_spec

    mesh = parse_mesh_spec("host:8", device="cpu")
    assert mesh.shape == {"data": 1, "model": 8} and mesh.device == "cpu"
    mesh = parse_mesh_spec("host:8@4")
    assert mesh.shape == {"data": 2, "model": 4}
    ax = mesh_axes(mesh)
    assert ax["model_size"] == 4 and ax["data_size"] == 2
    assert ax["dp_axes"] == ("data",)


def test_cache_shard_axes_and_signatures():
    """Placement names each sharded leaf's shard axis and moves nothing;
    the signatures are each leaf's global shape and one shard's block."""
    from repro_torch.dist import cache_shape_signatures, cache_shard_axes
    from repro_torch.launch.mesh import parse_mesh_spec

    eng, cache = build("port", 2, "dense", n_layers=3)
    axes = cache_shard_axes(eng, parse_mesh_spec("host:2"), cache)
    assert axes["site"]["prev_out"] == 1
    assert axes["site"]["sensor"]["skipped_tiles"] == 1
    assert axes["site"]["mode_host"] is None  # the host mirror
    with pytest.raises(ValueError, match="planned for 2 shards"):
        cache_shard_axes(eng, parse_mesh_spec("host:4"), cache)
    sigs = cache_shape_signatures(cache, axes)
    assert ("float32", (3, 2, 2, 64)) in sigs
    assert ("float32", (3, 1, 2, 64)) in sigs
    assert ("int8", (3, 1, 2, 256)) in sigs
    assert not any(dims == (3, 2) for _, dims in sigs)  # one value a lane


def test_no_gather_check_flags_a_gather_and_passes_the_step():
    """One eager sharded decode step passes; a step that gathers the
    shards' prev_out lanes (a cat of the lanes) is flagged, and so is a
    collective on a cache leaf's signature or storage, or one the
    recorder did not see."""
    from repro_torch.dist import cache_shape_signatures, cache_shard_axes
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.roofline.collectives import (
        cache_collective_violations,
        trace_step,
    )

    eng, cache = build("port", 2, "kernel", n_layers=2)
    sigs = cache_shape_signatures(
        cache, cache_shard_axes(eng, parse_mesh_spec("host:2"), cache))
    w = torch.randn(256, 128)

    def step():
        for layer in range(2):
            view = eng.layer_view(cache, layer)["site"]
            eng.apply("site", torch.randn(2, 256), w, None, view)

    assert cache_collective_violations(trace_step(step), sigs) == []
    gather = trace_step(lambda: cache["site"]["prev_out"].clone())
    [v] = cache_collective_violations(gather, sigs)
    assert v["kind"] == "move" and ("float32", (2, 2, 2, 64)) in v["operands"]
    # a collective the profiler names but the recorder did not see has
    # unknown operands: flagged. One the recorder saw is a violation only
    # on a cache leaf's signature or storage (the reference's rule), so a
    # recorded activation all-gather passes
    from repro_torch.roofline.collectives import collective_count

    named = {"events": ["ncclKernel_AllGather_RING_LL"], "moves": []}
    assert cache_collective_violations(named, sigs)[0]["kind"] == "collective"
    assert cache_collective_violations(named, sigs)[0]["unseen"] == 1
    assert collective_count(named) == 1
    panel = {"events": [], "kernels": ["ncclDevKernel_AllGather_RING_LL"],
             "moves": [], "collectives": [
                 ("c10d._allgather_base_.default", [("float32", (2, 128))],
                  [0], 1024)]}
    assert cache_collective_violations(panel, sigs) == []
    assert collective_count(panel) == 1
    lane = cache["site"]["prev_out"]
    on_cache = {"events": [], "moves": [], "collectives": [
        ("c10d._allgather_base_.default", [("float32", (2, 1, 2, 64))],
         [0], 1024)]}
    assert cache_collective_violations(on_cache, sigs)[0]["kind"] == \
        "collective"
    aliased = {"events": [], "moves": [], "collectives": [
        ("c10d._allgather_base_.default", [("float32", (2, 64))],
         [lane.untyped_storage().data_ptr()], 512)]}
    assert cache_collective_violations(aliased, sigs) == []
    [v] = cache_collective_violations(aliased, sigs, {
        lane.untyped_storage().data_ptr()})
    assert v["kind"] == "collective" and v["aliases_cache"]


def test_compiled_step_keys_the_shard_plan():
    from repro_torch.serve.compiled_step import CompiledStep

    cfg = ARCHS["qwen3-32b"].reduced()
    keys = []
    for n_shards in (1, 2):
        eng = tserve.build_reuse_engine(cfg, impl="torch")
        eng.shard_sites(n_shards)
        rc = eng.init_cache(2, device="cpu")
        state = tserve.init_serve_state(cfg, 2, 16, device="cpu")
        step = CompiledStep({}, cfg, state, batch=2, engine=eng, rcache=rc,
                            graphs=False)
        keys.append(step.decode_key())
    assert keys[0][1] == keys[1][1]  # the same specs
    assert keys[0][3] == () and keys[1][3] == tuple(
        sorted((n, 2) for n in eng.sites))


# ------------------------------------------------------ cost-model pricing

def test_build_report_prices_sharded_ici():
    """A sharded report carries the mesh provenance keys and an E_ICI row
    the unsharded report does not; the counter truth is shard-invariant,
    and both equal the reference's reports."""
    from repro_torch.sensor.cost_model import sensor_energy

    _, entry_1, eng_1 = run_stream("port", 1, "dense", 0.5, 9)
    _, entry_4, eng_4 = run_stream("port", 4, "dense", 0.5, 9)
    _, entry_j, eng_j = run_stream("ref", 4, "dense", 0.5, 9)
    eng_4.ctrl_snapshot({"site": entry_4})
    eng_j.ctrl_snapshot({"site": entry_j})
    rep_1 = eng_1.sensor_report({"site": entry_1})
    rep_4 = eng_4.sensor_report({"site": entry_4})
    rep_j = eng_j.sensor_report({"site": entry_j})
    assert "mesh_model_shards" not in rep_1.model
    assert rep_4.model["mesh_model_shards"] == 4
    assert rep_4.model["ici_reduce_bytes"] > 0.0
    assert rep_1.model["skipped_tiles"] == rep_4.model["skipped_tiles"]
    assert rep_1.model["computed_macs"] == rep_4.model["computed_macs"]
    assert rep_4.model == rep_j.model
    assert rep_4.to_dicts() == rep_j.to_dicts()
    assert "ici_j" in sensor_energy(rep_4)
    assert "ici_j" not in sensor_energy(rep_1)


# ------------------------------------------------------- journal v5 / replay

def _shard_row(shard, before, after, interval=1, site="s"):
    return {"kind": "decision", "decision_kind": "shard", "site": site,
            "field": "skip_rate", "layer": None, "shard": shard,
            "before": before, "after": after, "interval": interval,
            "step": interval * 4, "reason": "windowed cross-mesh reduce"}


def test_replay_chains_per_shard_and_detects_forged_shard():
    from repro_torch.control.replay import replay_rows

    good = [_shard_row(0, None, 0.5), _shard_row(1, None, 0.1),
            _shard_row(0, 0.5, 0.6, interval=2),
            _shard_row(1, 0.1, 0.2, interval=2)]
    res = replay_rows(good)
    assert res.ok and res.n_shard_scoped == 4
    assert res.final_state[("s", "shard", "skip_rate", None, 0)] == 0.6
    forged = good[:2] + [_shard_row(1, 0.5, 0.6, interval=2)]
    res = replay_rows(forged)
    assert not res.ok
    [m] = res.mismatches
    assert m["shard"] == 1 and m["before"] == 0.5 and m["replayed"] == 0.1
    assert "#s1" in "\n".join(res.summary_lines())


def test_journal_v5_roundtrip_and_old_versions_default_shard_none(tmp_path):
    from repro.control.report import load_journal as jload_journal
    from repro_torch.control.replay import replay_rows
    from repro_torch.control.report import (
        CONTROL_JOURNAL_SCHEMA_VERSION,
        ControlReport,
        Decision,
        DecisionJournal,
        load_journal,
    )

    assert CONTROL_JOURNAL_SCHEMA_VERSION == 5
    p = tmp_path / "j.jsonl"
    j = DecisionJournal(str(p))
    j.append(ControlReport(
        step=4, interval=1, window_steps={"s": 4}, retrace={},
        decisions=[Decision(step=4, site="s", kind="shard",
                            field="skip_rate", before=None, after=0.25,
                            shard=2, reason="window")]))
    v4 = {"kind": "decision", "schema_version": 4, "site": "s",
          "decision_kind": "retune", "field": "sim_threshold",
          "before": 0.1, "after": 0.2, "layer": 1, "interval": 1, "step": 4,
          "reason": "r"}
    with open(p, "a") as f:
        f.write(json.dumps(v4) + "\n")
    rows = load_journal(str(p))
    decisions = [r for r in rows if r["kind"] == "decision"]
    assert decisions[0]["shard"] == 2
    assert decisions[1]["shard"] is None
    assert replay_rows(rows).ok
    assert rows == jload_journal(str(p))


# ------------------------------------------- kv_head_pad_to against the JAX

def test_kv_head_pad_to_prefill_and_decode_match_reference():
    """KV heads duplicated into the cache (reduced qwen3: 2 KV heads padded
    to 4): a prefill and 4 decode steps without reuse, logits and the
    padded caches within the archetype tests' step tolerance."""
    jcfg = dataclasses.replace(JARCHS["qwen3-32b"].reduced(),
                               kv_head_pad_to=4)
    tcfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(), kv_head_pad_to=4)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, tcfg, "cpu")
    b, prompt, cache_len = 2, 8, 16
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (b, prompt)).astype(np.int32)
    jstate = jserve.init_serve_state(jcfg, b, cache_len)
    tstate = tserve.init_serve_state(tcfg, b, cache_len, device="cpu")
    assert tuple(tstate["blocks"]["k"].shape) == jstate["blocks"]["k"].shape
    assert tstate["blocks"]["k"].shape[3] == 4
    jlog, jstate = jserve.prefill_step(tree, jcfg, jnp.asarray(toks), jstate)
    tlog, tstate = tserve.prefill_step(tparams, tcfg, torch.from_numpy(toks),
                                       tstate)
    np.testing.assert_allclose(t2n(tlog), np.asarray(jlog), atol=STEP_TOL,
                               rtol=STEP_TOL)
    for _ in range(4):
        tok = np.array(jserve.greedy_sample(jlog))
        jlog, jstate, _ = jserve.decode_step(tree, jcfg, jnp.asarray(tok),
                                             jstate)
        tlog, tstate, _ = tserve.decode_step(tparams, tcfg,
                                             torch.from_numpy(tok), tstate)
        np.testing.assert_allclose(t2n(tlog), np.asarray(jlog),
                                   atol=STEP_TOL, rtol=STEP_TOL)
    for key in ("k", "v"):
        got, want = t2n(tstate["blocks"][key]), np.asarray(
            jstate["blocks"][key])
        np.testing.assert_allclose(got, want, atol=STEP_TOL, rtol=STEP_TOL)
        # each duplicated head holds its source head
        np.testing.assert_array_equal(got[:, :, :, 0], got[:, :, :, 1])


# ---------------------------------- the sharded serve against the reference

SERVE = ["--reduced", "--requests", "4", "--batch-slots", "2",
         "--prompt-len", "8", "--cache-len", "48", "--max-new", "6",
         "--reuse", "--mesh", "host:2", "--control-every", "2"]
SERVE_ARCHS = ("qwen3-32b", "mixtral-8x7b")

# the reference's serves, run in one subprocess: engines at impl="pallas"
# (the port's serve runs the kernel tier) and block_k 64 (so every shard
# owns k-tile columns of the reduced sites), the straggler watchdog pinned
# (it reads the host's clock), the mesh's axes Auto
_REFERENCE = """
import contextlib, io, json, sys
import jax
from jax.sharding import AxisType
from repro.guard import watchdog
watchdog.StragglerWatchdog.observe = lambda self, step, dt: None
from repro.launch import serve
build = serve.build_reuse_engine
serve.build_reuse_engine = lambda cfg, *, impl="jnp", policy=None: build(
    cfg, impl="pallas", policy=policy, block_k=64)
make_mesh = jax.make_mesh
jax.make_mesh = lambda shape, axes, **kw: make_mesh(
    shape, axes, axis_types=(AxisType.Auto,) * len(axes))
out = {}
for arch, journal, argv in json.loads(sys.argv[1]):
    sys.argv = ["serve", "--arch", arch, *argv, "--control-journal", journal]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main()
    out[arch] = buf.getvalue()
print(json.dumps(out))
"""


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("mesh:", "shard skip", "ici traffic",
                              "SensorReport"))]


def _rows(path):
    return [{k: v for k, v in json.loads(ln).items() if k != "ts"}
            for ln in open(path)]


@pytest.fixture(scope="module")
def sharded_serves(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    runs = [(arch, str(d / f"{arch}-ref.jsonl"), SERVE)
            for arch in SERVE_ARCHS]
    # one thread: the subprocess runs beside the suite's other workers
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps(runs)], env=env, capture_output=True,
                          text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    mp = pytest.MonkeyPatch()
    from repro_torch.guard import watchdog

    mp.setattr(watchdog.StragglerWatchdog, "observe",
               lambda self, step, dt: None)
    build = tserve_cli.build_reuse_engine
    mp.setattr(tserve_cli, "build_reuse_engine",
               lambda cfg, *, impl, policy=None: build(
                   cfg, impl=impl, policy=policy, block_k=64))
    port = {}
    for arch in SERVE_ARCHS:
        tree = jax.tree.map(np.asarray, jinit_params(
            JARCHS[arch].reduced(), jax.random.PRNGKey(0)))
        params = params_from_numpy(tree, ARCHS[arch].reduced(), "cpu")
        mp.setattr(tserve_cli, "init_params",
                   lambda cfg, seed, device, p=params: p)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tserve_cli.run(
                ARCHS[arch].reduced(), tserve_cli.build_parser().parse_args(
                    ["--arch", arch, *SERVE, "--device", "cpu",
                     "--control-journal", str(d / f"{arch}-port.jsonl")]))
        port[arch] = {"text": buf.getvalue(), "res": res}
    mp.undo()
    return d, ref, port


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_matches_reference(sharded_serves, arch):
    """Journals row for row (per-shard rows among them), and the mesh,
    SensorReport, shard skip and ici traffic lines; replay verifies the
    port's journal and catches a forged shard in it."""
    from repro_torch.control.replay import replay_rows

    d, ref, port = sharded_serves
    got, want = _rows(d / f"{arch}-port.jsonl"), _rows(d / f"{arch}-ref.jsonl")
    assert got == want
    shard_rows = [r for r in got if r.get("decision_kind") == "shard"]
    assert {r["shard"] for r in shard_rows} == {0, 1}
    assert _lines(port[arch]["text"]) == _lines(ref[arch])
    assert "profiler no-gather check: OK" in port[arch]["text"]
    assert "hlo no-gather check: OK" in ref[arch]
    res = replay_rows(got)
    assert res.ok and res.n_shard_scoped == len(shard_rows)
    # a row under shard 1 whose `before` is on no chain of shard 1 (on
    # random prompts every shard's windowed skip rate is 0.0)
    last = [r for r in shard_rows if r["shard"] == 1][-1]
    forged = dict(last, before=last["after"] + 0.25, after=0.75,
                  interval=last["interval"] + 1)
    res = replay_rows(got + [forged])
    assert not res.ok and res.mismatches[0]["shard"] == 1
    eng = port[arch]["res"]["engine"]
    assert eng.shards and set(eng.shards.values()) == {2}


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "host:2"], "requires --reuse"),
    (["--reuse", "--mesh", "prod"], "256 cards"),
    (["--reuse", "--mesh", "host:3"], "divisible"),
])
def test_serve_mesh_errors(argv, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        tserve_cli.run(ARCHS["qwen3-32b"].reduced(),
                       tserve_cli.build_parser().parse_args(
                           ["--arch", "qwen3-32b", "--reduced", "--device",
                            "cpu", "--requests", "1", "--max-new", "2",
                            *argv]))
