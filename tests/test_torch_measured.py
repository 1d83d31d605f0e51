"""The port's measured-decode runner (`repro_torch.sensor.runner`) against
the reference's (`repro.sensor.runner`), on the CPU.

Both runners make reduced qwen3-32b or rwkv6-7b and decode the same
correlated stream: the port is given the reference's weights
(`repro.models.init_params(cfg, PRNGKey(seed))`, carried over with
`params_from_numpy`), and its stream draws from `default_rng(seed)` in the
reference's order. The reference runs its jnp impl (exec path "dense"), the
port its kernel tier's plain versions through `CompiledStep` (exec path
"kernel"). Every JSONL row of the two reports must be equal key for key and
value for value, bitwise, apart from exactly that exec_path; the final reuse
caches must match as in tests/test_torch_engine.py (counters, codes, lanes
bitwise, prev_out within the GEMM tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import init_params as jinit_params
from repro.sensor import runner as jrunner
from repro_torch.configs import ARCHS
from repro_torch.models import params_from_numpy
from repro_torch.sensor import runner as trunner
from repro_torch.sensor.cost_model import measured_skip_fractions
from test_torch_engine import assert_caches_match

STEPS, BATCH = 6, 2


def reference_params(arch, seed=0):
    tree = jax.tree.map(np.asarray,
                        jinit_params(JARCHS[arch].reduced(),
                                     jax.random.PRNGKey(seed)))
    return params_from_numpy(tree, ARCHS[arch].reduced(), "cpu")


def flip_at_2(site):
    """An on_step hook that forces `site`'s layer-0 lane to basic after step
    2; it works on both packages' engines."""
    def hook(i, engine, rcache):
        if i == 2:
            engine.set_mode(rcache, site, "basic", layer=0)
    return hook


def assert_rows_match(jrows, trows):
    """Every row equal key for key and value for value, except exec_path:
    "dense" (the reference's jnp impl) against "kernel" (the port)."""
    assert len(jrows) == len(trows)
    assert [r["kind"] for r in jrows] == [r["kind"] for r in trows]
    for j, t in zip(jrows, trows):
        assert list(j) == list(t)
        if j["kind"] == "model":
            assert j == t
            continue
        assert (j["exec_path"], t["exec_path"]) == ("dense", "kernel")
        assert {k: v for k, v in j.items() if k != "exec_path"} == \
            {k: v for k, v in t.items() if k != "exec_path"}, j["site"]


CASES = {
    "qwen3_corr95": ("qwen3-32b", dict(correlation=0.95)),
    "rwkv6_corr95": ("rwkv6-7b", dict(correlation=0.95)),
    "qwen3_burst": ("qwen3-32b", dict(correlation=0.5, burst=(2, 3))),
    "qwen3_refresh": ("qwen3-32b", dict(correlation=0.95,
                                        refresh_policy=True)),
    "qwen3_on_step": ("qwen3-32b", dict(correlation=0.95, on_step="attn_out")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_rows_match_reference(case):
    arch, kw = CASES[case]
    if "on_step" in kw:
        kw = dict(kw, on_step=flip_at_2(kw["on_step"]))
    jm = jrunner.run_measured_decode(arch, steps=STEPS, batch=BATCH, **kw)
    tm = trunner.run_measured_decode(arch, steps=STEPS, batch=BATCH,
                                     device="cpu",
                                     params=reference_params(arch), **kw)
    assert (tm.arch, tm.steps, tm.batch) == (jm.arch, jm.steps, jm.batch)
    assert_rows_match(jm.report.to_dicts(), tm.report.to_dicts())
    assert tm.report.summary_lines() == [
        ln.replace("exec=dense  ", "exec=kernel ")
        for ln in jm.report.summary_lines()]
    assert tm.skip_fractions == jm.skip_fractions
    assert_caches_match(jm.cache, tm.cache)
    model = tm.report.model
    assert model["steps"] == STEPS
    if case == "qwen3_corr95":
        # the correlated stream skips tiles; layer 0's attn_qkv sees the
        # anchor token again and again
        assert model["tile_skip_rate"] > 0.5
        l0 = next(r for r in tm.report.per_layer
                  if r.site == "attn_qkv" and r.layer == 0)
        assert l0.skipped_tiles > 0
    if case == "qwen3_refresh":
        # the reduced sites are below min_work: the refresh demotes them
        assert all(s.mode == "basic" and s.mode_transitions > 0
                   for s in tm.report.per_site)
    if case == "qwen3_on_step":
        modes = {(r.site, r.layer): r.mode for r in tm.report.per_layer}
        assert modes[("attn_out", 0)] == "basic"
        assert modes[("attn_out", 1)] == "reuse"
    # one decode key for the whole run, unless a mode changed
    decode = [k for k in tm.step.variants if k[0] == "decode"]
    assert len(decode) == (1 if case in ("qwen3_corr95", "rwkv6_corr95",
                                         "qwen3_burst") else 2)
    assert tm.step.captures == len(decode)


def test_runner_defaults_and_table_match_reference():
    import inspect

    jsig = inspect.signature(jrunner.run_measured_decode).parameters
    tsig = inspect.signature(trunner.run_measured_decode).parameters
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name
    assert list(tsig)[:len(jsig)] == list(jsig)
    assert set(tsig) - set(jsig) == {"device", "params", "cfg", "graphs",
                                     "impl"}
    assert tsig["device"].default == "cuda"
    assert tsig["impl"].default is None
    ported = [p for p in jrunner.MEASURED_OPERATING_POINTS
              if p[0] in ARCHS]
    assert trunner.MEASURED_OPERATING_POINTS == ported
    assert [a for a, _ in ported] == ["qwen3-32b", "mixtral-8x7b",
                                      "rwkv6-7b"]


def test_runner_cfg_and_own_weights_on_cpu():
    """`cfg` replaces the arch's config (here: reduced qwen3 cut to one
    layer); without `params` the runner makes its own weights from the
    seed; the same seed gives the same report."""
    import dataclasses

    cfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(), n_layers=1)
    runs = [trunner.run_measured_decode("qwen3-32b", steps=4, batch=3,
                                        correlation=0.95, seed=5,
                                        device="cpu", cfg=cfg)
            for _ in range(2)]
    rows = [r.report.to_dicts() for r in runs]
    assert rows[0] == rows[1]
    # one layer: one layer row per site
    assert [(r.site, r.layer) for r in runs[0].report.per_layer] == [
        (s, 0) for s in ("attn_qkv", "attn_out", "mlp_in", "mlp_out")]
    assert runs[0].report.model["steps"] == 4
    assert len(runs[0].report.per_site[0].slot_steps) == 3
    assert measured_skip_fractions(runs[0].report) == runs[0].skip_fractions
    assert int(runs[0].step.state["len"]) == 4


def test_runner_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.run_measured_decode("qwen3-32b", steps=1)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        trunner.run_measured_decode("qwen3-32b", steps=1, device="cpu",
                                    graphs=True)
