"""The sharded reuse serve placed one shard a process (`torchrun`, gloo on
the CPU) against the port's one-process sharded serve, on the CPU.

`serve --mesh host:2` under a process group of 2 ranks (rank r holds
model-axis shard r, its cache only that lane, `repro_torch.dist.shard.
cache_shardings`; each site call all-gathers the output panels) must be
bitwise the one-process `host:2` serve: tokens, every line the reference
prints (timings, paths and the lines only one of the two prints set
aside), the control journal row for row, and each rank's final cache
equal to that lane of the one-process cache. Every run loads the
reference's weights (`repro.models.init_params`, as
`tests/test_torch_shard.py` does), and the placed serve is also held
against the reference's own `serve --mesh host:2` (two XLA host devices,
`device_put` placement) on the same inputs: journal rows and the mesh,
SensorReport, shard skip and ici traffic lines. After the serve, each run
reads the ctrl snapshot (dict-equal, with equal `ici_reduce_bytes`) and
counts the device→host copies one `Controller.step` makes (2, 3 with the
guard).
Then: a NaN in shard 1's lane trips the breaker at the same step; garbage
in shard 1's ctrl lanes (its mode 7) leaves every rank on shard 0's mode,
as on one device; a checkpoint saved placed restores into the one-process
serve and the reverse; `host:4@2` (a data axis of 2) on 4 ranks; the
errors.

Every run is a subprocess of one worker script (`_WORKER`): the placed
ones under `python -m torch.distributed.run --standalone` (a rendezvous on
a port bound at 0), one thread a rank, block_k 64 as in
`tests/test_torch_shard.py`, the straggler watchdog pinned. The runs that
depend on nothing start together.
"""

import json
import os
import pathlib
import pickle
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.dist.shard import cache_shardings as jcache_shardings
from test_torch_shard import SERVE as REF_SERVE
from test_torch_shard import _REFERENCE, _lines

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE = ["--reduced", "--requests", "4", "--batch-slots", "2",
         "--prompt-len", "8", "--cache-len", "48", "--max-new", "6",
         "--reuse", "--control-every", "2", "--device", "cpu"]
ARCHS = ("qwen3-32b", "mixtral-8x7b")
# a NaN written into shard 1's lane of layer 1's mlp_out prev_out after
# decode step 3
NAN = "poison-nan:at_step=3,site=mlp_out,layer=1,shard=1"
# mode 7 and cooldown -3 written into shard 1's ctrl lanes of layer 1's
# mlp_out after decode step 7, once every layer has flipped to basic (step 6)
GARBAGE = "ctrl-garbage:at_step=7,site=mlp_out,layer=1,shard=1"

_WORKER = r'''
import contextlib, io, json, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import ARCHS
from repro_torch.control import ControlConfig, Controller
from repro_torch.guard import QuarantineBreaker, watchdog
from repro_torch.launch import serve

watchdog.StragglerWatchdog.observe = lambda self, step, dt: None
build = serve.build_reuse_engine
serve.build_reuse_engine = lambda cfg, *, impl, policy=None: build(
    cfg, impl=impl, policy=policy, block_k=64)
spec = json.loads(sys.argv[1])
if spec.get("params"):  # the reference's weights
    from repro_torch.models import params_from_numpy
    with open(spec["params"], "rb") as f:
        tree = pickle.load(f)
    serve.init_params = lambda cfg, seed, device: params_from_numpy(
        tree, cfg, device)
rank = int(os.environ.get("RANK", 0))
out = {"rank": rank}
restore = serve.restore_cache_ckpt


def dumped(cache):
    flat = {}
    for name, entry in cache.items():
        for k, v in entry.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                key = f"{name}.{k}" + (f".{kk}" if kk else "")
                flat[key] = (vv.detach().clone() if isinstance(vv, torch.Tensor)
                             else np.array(vv))
    return flat


def restoring(directory, engine, rcache, journal, **kw):
    restore(directory, engine, rcache, journal, **kw)
    out["restored"] = dumped(rcache)


serve.restore_cache_ckpt = restoring
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        res = serve.run(ARCHS[spec["arch"]].reduced(),
                        serve.build_parser().parse_args(spec["argv"]))
except Exception as e:
    out["error"] = f"{type(e).__name__}: {e}"
    res = None
out["text"] = buf.getvalue()
if res is not None:
    step, eng, rc = res["step"], res["engine"], res["rcache"]
    out["tokens"] = {r.rid: list(map(int, r.output)) for r in res["done"]}
    out["cache"] = dumped(rc)
    out["snapshot"] = eng.ctrl_snapshot(rc, sentinels=True)
    out["ici"] = (eng.ici_reduce_bytes, eng.ici_write_bytes)
    copies, cpu = {}, torch.Tensor.cpu
    for guarded in (False, True):
        ctl = Controller(ControlConfig(min_window_steps=2),
                         guard=QuarantineBreaker() if guarded else None)
        for i in (2, 4):
            for _ in range(2):
                step.decode(step.tokens)
            if i == 2:
                ctl.step(eng, rc, step=i)
                continue
            n = [0]

            def counting(self, *a, **k):
                n[0] += 1
                return cpu(self, *a, **k)

            torch.Tensor.cpu = counting
            try:
                ctl.step(eng, rc, step=i)
            finally:
                torch.Tensor.cpu = cpu
            copies[guarded] = n[0]
    out["copies"] = copies
with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
'''


# each rank: one placed site call passes the no-gather check; an
# all-gather of a prev_out lane (a view of the cache leaf: no signature) is
# flagged by its storage, one of the whole leaf (its size-1 block's
# signature) by its shape
_GATHER = r'''
import json, os, pickle, sys
import torch
torch.set_num_threads(1)
from repro_torch.core.engine import ReuseEngine
from repro_torch.dist import cache_shape_signatures, cache_shard_axes
from repro_torch.launch.mesh import (
    parse_mesh_spec, place_mesh, start_process_group)
from repro_torch.roofline.collectives import (
    cache_collective_violations, cache_storages, collective_count,
    trace_step)

out = json.loads(sys.argv[1])["out"]
rank, world, dev = start_process_group("cpu")
mesh = place_mesh(parse_mesh_spec("host:2", device="cpu"), rank, world, dev)
eng = ReuseEngine(impl="torch")
eng.register("site", 256, 128, n_layers=2, block_m=4, block_k=64)
eng.shard_sites(2)
eng.place(mesh.placement)
cache = eng.init_cache(2, device="cpu")
sigs = cache_shape_signatures(cache, cache_shard_axes(eng, mesh, cache),
                              n_shards=2)
store = cache_storages(cache)
w = torch.randn(256, 128, generator=torch.Generator().manual_seed(0))


def step():
    for layer in range(2):
        eng.apply("site", torch.ones(2, 256), w, None,
                  eng.layer_view(cache, layer)["site"])


prev = cache["site"]["prev_out"]
res = {}
for what, fn in (("step", step),
                 ("lane", lambda: mesh.placement.all_gather(prev[1, 0])),
                 ("leaf", lambda: mesh.placement.all_gather(prev))):
    trace = trace_step(fn)
    res[what] = {"count": collective_count(trace),
                 "by_storage": cache_collective_violations(trace, sigs,
                                                           store),
                 "by_shape": cache_collective_violations(trace, sigs)}
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''


def _launch(tmp: pathlib.Path, name: str, arch: str, argv: list,
            ranks: int = 0, script: str = "worker.py") -> tuple:
    """Start one run of `script` (the worker unless named; `ranks` 0: one
    process, no group), on the reference's weights of `arch`."""
    out = tmp / name
    out.mkdir()
    params = tmp / f"params-{arch}.pkl"
    spec = json.dumps({"arch": arch, "out": str(out),
                       "argv": ["--arch", arch, *argv],
                       "params": str(params) if params.exists() else None})
    cmd = [sys.executable]
    if ranks:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks)]
    cmd += [str(tmp / script), spec]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    # a session of its own: a run that hangs is killed with its ranks
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return name, out, proc, max(ranks, 1)


def _collect(job) -> list[dict]:
    name, out, proc, n = job
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)  # torchrun passes it on
        try:
            log, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log = ""
        raise AssertionError(f"{name} hung: {log[-4000:]}") from None
    assert proc.returncode == 0, f"{name}: {log[-4000:]}"
    runs = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


def _reference(tmp: pathlib.Path) -> subprocess.Popen:
    """The reference's `serve --mesh host:2` of each arch (two XLA host
    devices), started in the background: `tests/test_torch_shard.py`'s
    runner, with the journals under `tmp`."""
    runs = [(arch, str(tmp / f"{arch}-ref.jsonl"), REF_SERVE)
            for arch in ARCHS]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             json.dumps(runs)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.models import init_params as jinit_params

    tmp = tmp_path_factory.mktemp("placement")
    (tmp / "worker.py").write_text(_WORKER)
    (tmp / "gather.py").write_text(_GATHER)
    for arch in ARCHS:
        tree = jax.tree.map(np.asarray, jinit_params(
            JARCHS[arch].reduced(), jax.random.PRNGKey(0)))
        with open(tmp / f"params-{arch}.pkl", "wb") as f:
            pickle.dump(tree, f)
    ref = _reference(tmp)
    journal = ["--mesh", "host:2", "--control-journal"]
    jobs = []
    for arch in ARCHS:
        for how, ranks in (("one", 0), ("placed", 2)):
            ck = ["--cache-ckpt", str(tmp / f"ck-{arch}-{how}")] \
                if arch == "qwen3-32b" else []
            jobs.append(_launch(
                tmp, f"{arch}-{how}", arch,
                SERVE + journal + [str(tmp / f"{arch}-{how}.jsonl")] + ck,
                ranks))
    for how, ranks in (("one", 0), ("placed", 2)):
        jobs.append(_launch(
            tmp, f"nan-{how}", "qwen3-32b",
            SERVE + journal + [str(tmp / f"nan-{how}.jsonl"), "--inject",
                               NAN], ranks))
        jobs.append(_launch(
            tmp, f"garbage-{how}", "qwen3-32b",
            SERVE + journal + [str(tmp / f"garbage-{how}.jsonl"), "--inject",
                               GARBAGE], ranks))
        jobs.append(_launch(
            tmp, f"data-{how}", "qwen3-32b",
            SERVE + ["--mesh", "host:4@2", "--control-journal",
                     str(tmp / f"data-{how}.jsonl")], 4 if ranks else 0))
    jobs.append(_launch(tmp, "world", "qwen3-32b",
                        SERVE + ["--mesh", "host:4"], 2))
    jobs.append(_launch(tmp, "prod", "qwen3-32b",
                        SERVE + ["--mesh", "prod"], 2))
    jobs.append(_launch(tmp, "gather", "", [], 2, script="gather.py"))
    got = {job[0]: _collect(job) for job in jobs}
    # the restores: each serve from a copy of the other's checkpoint
    again = []
    for how, other, ranks in (("one", "placed", 0), ("placed", "one", 2)):
        src = tmp / f"ck-qwen3-32b-{other}"
        dst = tmp / f"restore-{how}-ck"
        shutil.copytree(src, dst)
        again.append(_launch(tmp, f"restore-{how}", "qwen3-32b",
                             SERVE + ["--mesh", "host:2", "--cache-ckpt",
                                      str(dst)], ranks))
    got.update({job[0]: _collect(job) for job in again})
    try:
        stdout, stderr = ref.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(ref.pid, signal.SIGKILL)
        raise AssertionError("the reference's serves hung") from None
    assert ref.returncode == 0, stderr[-3000:]
    got["reference"] = json.loads(stdout.strip().splitlines()[-1])
    return tmp, got


# the lines only one of the two serves prints, or that carry a time or a
# path: everything else rank 0 prints must be the one-process serve's
_SET_ASIDE = ("mesh placement:", "reuse cache:", "profiler no-gather",
              "decode step:", "decode loop:", "served ", "decision journal:",
              "cache checkpoint:", "compiled step: ")


def _printed(text: str) -> list[str]:
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith(_SET_ASIDE)]


def _rows(path):
    return [{k: v for k, v in json.loads(ln).items() if k != "ts"}
            for ln in open(path)]


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _assert_lanes(one: dict, placed: list[dict], key: str = "cache",
                  shards: int = 2):
    """Each rank's cache leaves equal to its lane of the one-process cache
    (rank r holds shard r % shards): the one axis whose width differs is
    the shard axis, of width 1 on a rank."""
    for rank, run in enumerate(placed):
        assert run[key].keys() == one[key].keys()
        for path, want in one[key].items():
            got = run[key][path]
            diff = [i for i, (x, y) in enumerate(zip(want.shape, got.shape))
                    if x != y]
            if diff:
                [ax] = diff
                assert got.shape[ax] == 1, (path, got.shape)
                want = (want.narrow(ax, rank % shards, 1)
                        if isinstance(want, torch.Tensor)
                        else np.take(want, [rank % shards], axis=ax))
            assert _equal(got, want), (rank, path)


def _snap_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for name in a:
        if a[name].keys() != b[name].keys():
            return False
        for k, v in a[name].items():
            w = b[name][k]
            if isinstance(v, np.ndarray):
                if v.dtype != w.dtype or not np.array_equal(v, w,
                                                            equal_nan=True):
                    return False
            elif v != w:
                return False
    return True


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_serve_is_the_one_process_serve(runs, arch):
    """Tokens, printed lines and journal rows of rank 0 equal the
    one-process serve's; every rank decoded the same tokens and holds its
    lane of the one-process cache, bitwise."""
    tmp, got = runs
    [one], placed = got[f"{arch}-one"], got[f"{arch}-placed"]
    for run in placed:
        assert "error" not in run, run.get("error")
        assert run["tokens"] == one["tokens"]
    assert _printed(placed[0]["text"]) == _printed(one["text"])
    assert placed[1]["text"] == ""  # rank 1 prints nothing
    assert _rows(tmp / f"{arch}-placed.jsonl") == _rows(tmp / f"{arch}-one.jsonl")
    assert "mesh placement: all 2 ranks decoded the same tokens" in \
        placed[0]["text"]
    _assert_lanes(one, placed)
    assert any(ln.startswith("shard skip") for ln in placed[0]["text"]
               .splitlines())


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_serve_matches_the_reference(runs, arch):
    """On the reference's weights, the placed serve's journal (per-shard
    rows among them) and its mesh, SensorReport, shard skip and ici
    traffic lines are the reference's `serve --mesh host:2`, whose cache
    sits one shard a device (`device_put` with `cache_shardings`)."""
    tmp, got = runs
    ref = got["reference"][arch]
    text = got[f"{arch}-placed"][0]["text"]
    rows = _rows(tmp / f"{arch}-placed.jsonl")
    assert rows == _rows(tmp / f"{arch}-ref.jsonl")
    assert {r["shard"] for r in rows
            if r.get("decision_kind") == "shard"} == {0, 1}
    assert _lines(text) == _lines(ref)
    assert any(ln.startswith("SensorReport rid=") for ln in _lines(text))
    assert "hlo no-gather check: OK" in ref


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_snapshot_and_copies(runs, arch):
    """The ctrl snapshot (with the sentinel lanes) is dict-equal to the
    one-process one on every rank, with equal interconnect meters, and one
    Controller.step makes 2 device->host copies, 3 with the guard."""
    _, got = runs
    [one], placed = got[f"{arch}-one"], got[f"{arch}-placed"]
    assert one["copies"] == {False: 2, True: 3}
    for run in placed:
        assert _snap_equal(run["snapshot"], one["snapshot"])
        assert run["ici"] == one["ici"]
        assert run["copies"] == one["copies"]


def test_placed_no_gather_line_counts_the_panel_gathers(runs):
    """The placed step all-gathers one output panel a site and layer, and
    passes the no-gather check; the one-process step gathers nothing."""
    _, got = runs
    [one], placed = got["qwen3-32b-one"], got["qwen3-32b-placed"]
    line = [ln for ln in placed[0]["text"].splitlines()
            if ln.startswith("profiler no-gather check: OK")]
    assert line and "(8 collectives," in line[0], line  # 4 sites x 2 layers
    assert "(0 collectives, 0.0 KB/card" in one["text"]


def test_no_gather_check_flags_a_gathered_cache_lane(runs):
    """Under a real process group: the placed step's panel all-gathers
    (one a layer) pass; an all-gather of a prev_out lane is flagged by its
    storage, and one of the whole leaf also by its shape."""
    _, got = runs
    for res in got["gather"]:
        assert res["step"]["count"] == 2
        assert res["step"]["by_storage"] == [] == res["step"]["by_shape"]
        [v] = res["lane"]["by_storage"]
        assert v["kind"] == "collective" and v["aliases_cache"]
        assert res["lane"]["by_shape"] == []
        [v] = res["leaf"]["by_shape"]
        assert ("float32", (2, 1, 2, 64)) in v["operands"]
        assert res["leaf"]["by_storage"][0]["aliases_cache"]


def test_nan_in_shard_one_trips_at_the_same_step(runs):
    """A NaN written into shard 1's lane (rank 1's) trips nonfinite_out at
    the same step, and the journals match row for row."""
    tmp, got = runs
    [one], placed = got["nan-one"], got["nan-placed"]
    rows = _rows(tmp / "nan-placed.jsonl")
    assert rows == _rows(tmp / "nan-one.jsonl")
    trips = [r for r in rows if r.get("decision_kind") == "quarantine"
             and r.get("after") == "quarantined"]
    assert trips and trips[0]["step"] == 4 and trips[0]["layer"] == 1
    assert "nonfinite_out" in trips[0]["reason"]
    assert placed[0]["tokens"] == one["tokens"]
    assert _printed(placed[0]["text"]) == _printed(one["text"])
    _assert_lanes(one, placed)


def test_ctrl_garbage_in_shard_one_keeps_shard_zeros_mode(runs):
    """Mode 7 written into shard 1's ctrl lane (rank 1's card, and every
    rank's host mirror): every rank takes shard 0's mode, as the
    one-process serve does, so tokens, printed lines, journal rows and
    each rank's cache lane stay the one-process serve's."""
    tmp, got = runs
    [one], placed = got["garbage-one"], got["garbage-placed"]
    for run in placed:
        assert "error" not in run, run.get("error")
        assert run["tokens"] == one["tokens"]
    assert "ctrl-garbage @step 7" in one["text"]
    assert _printed(placed[0]["text"]) == _printed(one["text"])
    assert _rows(tmp / "garbage-placed.jsonl") == _rows(
        tmp / "garbage-one.jsonl")
    _assert_lanes(one, placed)


def test_checkpoint_round_trips_between_placed_and_one_process(runs):
    """The placed serve's checkpoint is the one-process serve's, file for
    file; each restores into the other bitwise (each rank its own lane),
    and the two restored serves run on alike."""
    tmp, got = runs
    a, b = tmp / "ck-qwen3-32b-one", tmp / "ck-qwen3-32b-placed"
    [step] = [p.name for p in a.iterdir() if p.is_dir()]
    za = np.load(a / step / "host_00000.npz")
    zb = np.load(b / step / "host_00000.npz")
    assert sorted(za.files) == sorted(zb.files)
    for key in za.files:
        assert za[key].dtype == zb[key].dtype
        assert np.array_equal(za[key], zb[key]), key
    [one], placed = got["restore-one"], got["restore-placed"]
    # restored from each other's files: the one-process serve from the
    # placed one's, the placed ranks from the one-process one's
    _assert_lanes(one, placed, key="restored")
    _assert_lanes(one, placed)
    assert placed[0]["tokens"] == one["tokens"]
    assert _printed(placed[0]["text"]) == _printed(one["text"])
    assert "cache checkpoint: restored step" in placed[0]["text"]


def test_data_axis_replicates_the_model_groups(runs):
    """`host:4@2` on 4 ranks: two data rows, each a model group of 2;
    every rank holds shard rank % 2, and the serve is the one-process
    `host:4@2` serve."""
    tmp, got = runs
    [one], placed = got["data-one"], got["data-placed"]
    assert len(placed) == 4
    for run in placed:
        assert run["tokens"] == one["tokens"]
    assert _printed(placed[0]["text"]) == _printed(one["text"])
    assert _rows(tmp / "data-placed.jsonl") == _rows(tmp / "data-one.jsonl")
    _assert_lanes(one, placed)


def test_placed_mesh_errors(runs):
    """A world size other than the mesh's raises with the reference's
    message shape; `prod` still raises, naming its 256 cards."""
    _, got = runs
    for run in got["world"]:
        assert run["error"].startswith(
            "RuntimeError: mesh wants 4 devices but the process group has 2 "
            "ranks"), run["error"]
    for run in got["prod"]:
        assert run["error"].startswith("NotImplementedError: mesh prod needs "
                                       "256 cards"), run["error"]


def test_cache_shardings_name_the_references_leaves_and_axes():
    """The ported `cache_shardings` puts each sharded leaf's block on the
    axis the reference's NamedSharding puts "model" on, and replicates the
    same leaves; the host mirror `mode_host`, which every rank keeps
    whole, is replicated."""
    import dataclasses

    import jax
    from jax.sharding import NamedSharding

    from repro.core.engine import ReuseEngine as JEngine
    from repro_torch.core.engine import ReuseEngine
    from repro_torch.dist import Placement, ShardBlock, cache_shardings
    from repro_torch.launch.mesh import parse_mesh_spec

    def build(pkg):
        eng = JEngine(impl="jnp") if pkg == "ref" else ReuseEngine(impl="torch")
        eng.register("stack", 256, 128, n_layers=3, block_m=4, block_k=64)
        eng.register("flat", 256, 64, block_m=4, block_k=64)
        eng.shard_sites(2)
        return eng, (eng.init_cache(batch=2) if pkg == "ref"
                     else eng.init_cache(2, device="cpu"))

    jeng, jcache = build("ref")
    # the reference's rules need no devices to name the axes: a 1x1 mesh,
    # the plan read as its model axis' width
    jeng.shards = {n: 1 for n in jeng.shards}
    want = jcache_shardings(jeng, jax.make_mesh((1, 1), ("data", "model")),
                            jcache)
    flat_want = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, NamedSharding))
    eng, cache = build("port")
    for shard in (0, 1):
        tmesh = dataclasses.replace(
            parse_mesh_spec("host:2", device="cpu"),
            placement=Placement(rank=shard, world=2, n_shards=2))
        got = cache_shardings(eng, tmesh, cache)
        for path, sh in flat_want:
            node = got
            for p in path:
                node = node[p.key]
            axes = [i for i, p in enumerate(sh.spec) if p == "model"]
            assert node == (ShardBlock(axes[0], shard) if axes else None), (
                path, node)
        for name in ("stack", "flat"):  # the host mirror: every lane
            assert got[name]["mode_host"] is None
            assert got[name]["ctrl"]["mode_id"] == ShardBlock(
                1 if name == "stack" else 0, shard)
    with pytest.raises(ValueError, match="placed mesh"):
        cache_shardings(eng, parse_mesh_spec("host:2", device="cpu"), cache)
