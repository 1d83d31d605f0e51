"""The port's decode slice end to end against the JAX package, and the
port's import hygiene and serve entry point.

Reduced qwen3-32b runs in f32. `build_reuse_engine(block_k=64)` gives gk >= 2
at every site (at block_k=256 a reduced model has gk = 1 and never skips).
The JAX weights are carried over with `params_from_numpy`; both sides
prefill the same prompts and decode the same tokens with reuse on, the JAX
side with impl="pallas" (the compiled-XLA tier on this host). Logits must
agree within rtol 1e-4 and atol 1e-4: the same f32 products are summed in
another order at every site and in attention, and the int8 activation codes
(which are compared too) are equal, so no code flip amplifies the
difference. Greedy tokens must be equal, and every sensor counter too."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.policy import ReusePolicy as JPolicy
from repro.core.policy import SiteTunables as JTunables
from repro.models import init_params as jinit_params
from repro.serve import serve_step as jserve
from repro_torch.configs import ARCHS
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import params_from_numpy
from repro_torch.serve import serve_step as tserve
from test_torch_engine import assert_caches_match

ROOT = pathlib.Path(__file__).resolve().parents[1]
SITES = ("attn_qkv", "attn_out", "mlp_in", "mlp_out")
B, PROMPT, CACHE, STEPS = 2, 8, 32, 4


def configs(variant):
    jcfg, tcfg = JARCHS["qwen3-32b"].reduced(), ARCHS["qwen3-32b"].reduced()
    if variant == "input_stationary":
        # mlp_out: 640 > 4·128, so the site takes the input-stationary path
        jcfg = dataclasses.replace(jcfg, d_ff=640)
        tcfg = dataclasses.replace(tcfg, d_ff=640)
    jpol, tpol = JPolicy(), ReusePolicy()
    if variant == "ragged":
        # max_active_k=1 < gk=2: live rows overflow the budget, exercising
        # the fallback's accounting
        jpol = JPolicy(site_tunables={
            s: JTunables(exec_path="ragged", max_active_k=1) for s in SITES})
        tpol = ReusePolicy(site_tunables={
            s: SiteTunables(exec_path="ragged", max_active_k=1) for s in SITES})
    if variant == "dense":
        # the reference's masked product outside any kernel (the guard's
        # shadow oracle), with its masked full-grid accounting
        jpol = JPolicy(site_tunables={
            s: JTunables(exec_path="dense") for s in SITES})
        tpol = ReusePolicy(site_tunables={
            s: SiteTunables(exec_path="dense") for s in SITES})
    return jcfg, tcfg, jpol, tpol


@pytest.mark.parametrize("variant", ["default", "input_stationary", "ragged",
                                     "dense"])
def test_decode_slice_matches_jax(rng, variant):
    jcfg, tcfg, jpol, tpol = configs(variant)
    assert tcfg == type(tcfg)(**dataclasses.asdict(jcfg))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    prompts = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jstate = jserve.init_serve_state(jcfg, B, CACHE)
    tstate = tserve.init_serve_state(tcfg, B, CACHE, device="cpu")
    jlog, jstate = jax.jit(lambda p, t, s: jserve.prefill_step(p, jcfg, t, s))(
        jparams, jnp.asarray(prompts), jstate)
    tlog, tstate = tserve.prefill_step(tparams, tcfg, torch.from_numpy(prompts),
                                       tstate)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)

    jeng = jserve.build_reuse_engine(jcfg, impl="pallas", block_k=64,
                                     policy=jpol)
    teng = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64,
                                     policy=tpol)
    if variant == "input_stationary":
        assert teng.sites["mlp_out"].dataflow == "input"
    jrc, trc = jeng.init_cache(B), teng.init_cache(B, device="cpu")
    jdecode = jax.jit(lambda p, t, s, rc: jserve.decode_step(
        p, jcfg, t, s, engine=jeng, reuse_cache=rc))
    # every step feeds the prefill's greedy token again: layer 0's attn_qkv
    # then sees an unchanged input and skips its tiles
    tok = np.array(jserve.greedy_sample(jlog))
    for _ in range(STEPS):
        jlog, jstate, jrc = jdecode(jparams, jnp.asarray(tok), jstate, jrc)
        tlog, tstate, trc = tserve.decode_step(
            tparams, tcfg, torch.from_numpy(tok), tstate, engine=teng,
            reuse_cache=trc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tserve.greedy_sample(tlog).numpy(),
                                      np.asarray(jserve.greedy_sample(jlog)))
    assert int(tstate["len"]) == int(jstate["len"]) == PROMPT + STEPS
    assert_caches_match(jrc, trc)
    skipped = sum(int(e["sensor"]["skipped_tiles"].sum()) for e in trc.values())
    assert skipped > 0  # the reuse skip was exercised
    if variant == "ragged":
        assert sum(int(e["sensor"]["overflow_fallbacks"].sum())
                   for e in trc.values()) > 0
    if variant == "dense":
        assert {s.exec_path for s in teng.sites.values()} == {"dense"}


def test_params_from_numpy_carries_bf16_exactly():
    jcfg = dataclasses.replace(JARCHS["qwen3-32b"].reduced(),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(),
                               param_dtype="bfloat16")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    wqkv = tparams["blocks"]["attn"]["wqkv"]
    assert wqkv.dtype == torch.bfloat16
    assert tuple(wqkv.shape) == (2, 128, 256)  # stacked [L, ...]
    np.testing.assert_array_equal(
        wqkv.float().numpy(),
        np.asarray(jparams["blocks"]["attn"]["wqkv"], np.float32))
    assert tparams["blocks"]["attn"]["norm"]["scale"].dtype == torch.float32


def test_serve_cli_on_cpu(capsys):
    tserve_cli.main(["--arch", "qwen3-32b", "--reduced", "--requests", "3",
                     "--batch-slots", "2", "--prompt-len", "4",
                     "--cache-len", "16", "--max-new", "3", "--reuse",
                     "--refresh-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "kernel substrate: backend=" in out
    assert out.count("SensorReport rid=") == 3
    assert "SensorReport model:" in out
    assert "served 3/3 requests" in out


def test_serve_inject_prints_the_reference_guard_lines(capsys, monkeypatch,
                                                     tmp_path):
    """`serve --inject` with the controller on reduced qwen3: the port's
    serve and the reference's arm the same fault, trip the same lane and
    print the same `guard plane:` and `fault injection:` lines. The fault
    lands at step 4, just before that step's control interval looks, so it
    trips in both; six decode steps, fewer than the watchdog's eight
    samples, and both watchdogs are pinned, so no wall-clock verdict can
    enter the lines."""
    from repro.launch import serve as jserve_cli
    from test_torch_obs import pin_watchdogs

    pin_watchdogs(monkeypatch)

    argv = ["--arch", "qwen3-32b", "--reduced", "--requests", "4",
            "--batch-slots", "2", "--prompt-len", "4", "--cache-len", "24",
            "--max-new", "4", "--reuse", "--control-every", "2",
            "--inject", "poison-nan:at_step=4,site=mlp_out,layer=1"]
    res = tserve_cli.run(ARCHS["qwen3-32b"].reduced(),
                         tserve_cli.build_parser().parse_args(
                             argv + ["--control-journal",
                                     str(tmp_path / "t.jsonl"),
                                     "--device", "cpu"]))
    port = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve", *argv, "--control-journal",
                                     str(tmp_path / "j.jsonl")])
    jserve_cli.main()
    ref = capsys.readouterr().out

    def guard_lines(text):
        lines = text.splitlines()
        keep = [ln for ln in lines if ln.startswith(
            ("guard plane:", "fault injection", "inject @step",
             "straggler:"))]
        at = lines.index(next(ln for ln in lines
                              if ln.startswith("fault injection:")))
        return keep + [ln for ln in lines[at + 1:] if ln.startswith("  ")]

    assert guard_lines(port) == guard_lines(ref)
    assert "guard plane: 1 sentinel trips, 0 stall windows" in port
    assert "poison-nan @step 4: prev_out[...,0,0] = NaN" in port
    assert res["breaker"].total_trips == 1 and res["injector"].fired
    assert res["breaker"].stall_windows == 0
    assert res["controller"].guard is res["breaker"]
    with pytest.raises(ValueError, match="--inject requires --reuse"):
        tserve_cli.main(["--arch", "qwen3-32b", "--reduced", "--inject",
                         "stall", "--device", "cpu"])


def test_serve_default_device_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve_cli.main(["--arch", "qwen3-32b", "--reduced", "--requests", "1",
                         "--reuse"])


def _imports(path: pathlib.Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the control plane and the guard plane are covered too
    assert {f.name for f in files if f.parent.name == "control"} >= {
        "report.py", "admit.py", "budget.py", "retune.py", "controller.py",
        "replay.py", "restore.py", "__init__.py"}
    # and checkpointing
    assert {f.name for f in files if f.parent.name == "ckpt"} >= {
        "checkpoint.py", "recovery.py", "__init__.py"}
    assert {f.name for f in files if f.parent.name == "guard"} >= {
        "sentinel.py", "quarantine.py", "inject.py", "watchdog.py",
        "__init__.py"}
    # and the observability plane and the replica harness
    assert {f.name for f in files if f.parent.name == "obs"} >= {
        "trace.py", "events.py", "metrics.py", "export.py", "latency.py",
        "stream.py", "fleet.py", "slo.py", "top.py", "__init__.py"}
    assert "replicas.py" in {f.name for f in files
                             if f.parent.name == "launch"}
    # and the MoE family and the quantization helpers
    assert {f.name for f in files if f.parent.name == "models"} >= {
        "moe.py", "layers.py", "transformer.py"}
    assert {"expert_reuse.py", "reuse_linear.py"} <= {
        f.name for f in files if f.parent.name == "core"}
    assert {f.name for f in files if f.parent.name == "configs"} >= {
        "mixtral_8x7b.py", "llama4_scout_17b_a16e.py"}
    assert "quantize.py" in {f.name for f in files
                             if f.parent.name == "quant"}
    # and training
    assert {f.name for f in files if f.parent.name == "train"} >= {
        "train_step.py", "__init__.py"}
    assert {f.name for f in files if f.parent.name == "optim"} >= {
        "adamw.py", "compression.py", "schedules.py", "__init__.py"}
    assert {f.name for f in files if f.parent.name == "data"} >= {
        "pipeline.py", "__init__.py"}
    assert {"train.py", "specs.py"} <= {f.name for f in files
                                        if f.parent.name == "launch"}
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
