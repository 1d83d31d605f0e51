"""The port's reuse engine against the JAX engine with impl="pallas".

On this CPU host impl="pallas" resolves to the compiled-XLA tier, which
tests/test_backend.py pins bitwise to the interpret-mode kernels; the port's
impl="cuda" takes the plain versions for CPU tensors. Both see the same
numpy-made input streams; after N steps every sensor counter must be bitwise
equal, the codes too, and outputs within the GEMM tolerance of
tests/test_kernels.py (rtol 1e-5, atol 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ReuseEngine as JEngine
from repro.core.policy import ReusePolicy as JPolicy
from repro.core.policy import SiteTunables as JTunables
from repro.tune.table import save_table
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.sensor.counters import COUNTER_KEYS
from repro_torch.serve.scheduler import ContinuousBatcher, Request, reset_slot
from repro_torch.tune.table import load_table, load_tuned_policy

M = 4
# name, in, out, mode, tunables
SITES = [
    ("qkv", 256, 384, "auto", {}),
    ("down", 640, 128, "auto", {}),                        # input-stationary
    ("rag", 256, 256, "auto", {"exec_path": "ragged", "max_active_k": 1}),
    ("rag_wide", 512, 128, "auto", {"exec_path": "ragged", "max_active_k": 5}),
    ("plain", 128, 128, "basic", {}),
]


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def build(n_layers):
    jt = {n: JTunables(**kw) for n, _, _, _, kw in SITES if kw}
    tt = {n: SiteTunables(**kw) for n, _, _, _, kw in SITES if kw}
    je = JEngine(impl="pallas", policy=JPolicy(site_tunables=jt))
    te = ReuseEngine(impl="cuda", policy=ReusePolicy(site_tunables=tt))
    for name, fi, fo, mode, _ in SITES:
        for eng in (je, te):
            eng.register(name, fi, fo, n_layers=n_layers, block_m=8,
                         block_k=64, mode=mode)
    return je, te


def stream(rng, steps, k):
    """Correlated activations: each step re-draws a random third of the
    64-wide K blocks, so tiles are skipped and computed."""
    x = rng.normal(size=(M, k)).astype(np.float32)
    out = [x.copy()]
    for _ in range(steps - 1):
        x = x.copy()
        for b in range(k // 64):
            if rng.random() < 0.33:
                x[:, b * 64:(b + 1) * 64] = rng.normal(size=(M, 64))
        out.append(x)
    return out


def run_both(rng, n_layers, steps=5):
    je, te = build(n_layers)
    jc = je.init_cache(M)
    tc = te.init_cache(M, device="cpu")
    lanes = range(n_layers) if n_layers else [None]
    for name, fi, fo, _, _ in SITES:
        w = (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32)
        # one compiled reference step per site, as the serve's jitted step
        japply = jax.jit(lambda x, w, e, name=name: je.apply(name, x, w, None, e))
        for lane in lanes:
            for x in stream(rng, steps, fi):
                if lane is None:
                    jo, jc[name], _ = japply(jnp.asarray(x), jnp.asarray(w),
                                             jc[name])
                    to, _, _ = te.apply(name, t(x), t(w), None, tc[name])
                else:
                    jl = jax.tree.map(lambda a: a[lane], jc[name])
                    jo, jl, _ = japply(jnp.asarray(x), jnp.asarray(w), jl)
                    jc[name] = jax.tree.map(lambda a, b: a.at[lane].set(b),
                                            jc[name], jl)
                    to, _, _ = te.apply(name, t(x), t(w), None,
                                        te.layer_view(tc, lane)[name])
                np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                           rtol=1e-5, atol=1e-4)
    return je, te, jc, tc


def assert_caches_match(jc, tc):
    """Every counter, code and lane bitwise equal, prev_out within the GEMM
    tolerance. The similarity-fed float lanes (slot_hit_sum, sim_ema,
    ctrl.occupancy) are bitwise too: the port rounds them as one FMA, as
    the reference's compiled step does."""
    for name in jc:
        js, ts = jc[name]["sensor"], tc[name]["sensor"]
        assert set(ts) == set(js) == set(COUNTER_KEYS)
        for key in COUNTER_KEYS:
            a, b = ts[key].numpy(), np.asarray(js[key])
            assert a.dtype == b.dtype, (name, key, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{key}")
        np.testing.assert_array_equal(tc[name]["prev_q"].numpy(),
                                      np.asarray(jc[name]["prev_q"]))
        np.testing.assert_allclose(tc[name]["prev_out"].numpy(),
                                   np.asarray(jc[name]["prev_out"]),
                                   rtol=1e-5, atol=1e-4)
        for key in ("steps", "scale"):
            np.testing.assert_array_equal(tc[name][key].numpy(),
                                          np.asarray(jc[name][key]))
        np.testing.assert_array_equal(tc[name]["sim_ema"].numpy(),
                                      np.asarray(jc[name]["sim_ema"]))
        for key, v in tc[name]["ctrl"].items():
            assert v.numpy().dtype == np.asarray(jc[name]["ctrl"][key]).dtype
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jc[name]["ctrl"][key]),
                                          err_msg=f"{name}.ctrl.{key}")


@pytest.mark.parametrize("n_layers", [0, 2])
def test_counters_bitwise_equal_after_steps(rng, n_layers):
    _, _, jc, tc = run_both(rng, n_layers)
    assert_caches_match(jc, tc)
    # the stream exercised both skipped and computed tiles, and the budget
    # overflow fallback of the ragged site
    total = lambda k: sum(int(tc[n]["sensor"][k].sum()) for n in tc)  # noqa
    assert total("skipped_tiles") > 0 and total("computed_tiles") > 0
    assert int(tc["rag"]["sensor"]["overflow_fallbacks"].sum()) > 0


def test_refresh_modes_and_report_match_reference(rng):
    je, te, jc, tc = run_both(rng, 2)
    # demote half the layers' threshold so the pass flips some lanes
    for eng, cache in ((je, jc), (te, tc)):
        tun = (JTunables if eng is je else SiteTunables)(sim_threshold=0.99)
        eng.apply_tunables("qkv", tun, cache, layer=1)
    jchanged = je.refresh_modes(jc)
    tchanged = te.refresh_modes(tc)
    assert tchanged == jchanged
    assert len(te.last_mode_events) == len(je.last_mode_events) > 0
    assert te.last_mode_events == je.last_mode_events
    assert te.sites == {n: _spec_like(s) for n, s in je.sites.items()}
    assert_caches_match(jc, tc)
    for name in te.sites:
        np.testing.assert_array_equal(np.atleast_1d(tc[name]["mode_host"]),
                                      je.entry_mode_ids(jc[name]))
    assert te.sensor_report(tc).summary_lines() == \
        je.sensor_report(jc).summary_lines()


@pytest.mark.parametrize("m", [3, 6, 16, 32, 64])
def test_ctrl_snapshot_and_refresh_modes_match_reference_at_batch(m):
    """sim_l bitwise at batch widths where a plain torch mean rounds other
    than the reference's compiled mean, and the mode pass that reads it."""
    rng = np.random.default_rng(m)
    je, te = build(2)
    jc, tc = je.init_cache(m), te.init_cache(m, device="cpu")
    for name in jc:
        sim = rng.random(tuple(jc[name]["sim_ema"].shape), dtype=np.float32)
        jc[name] = {**jc[name], "sim_ema": jnp.asarray(sim)}
        tc[name]["sim_ema"].copy_(t(sim))
    jsnap, tsnap = je.ctrl_snapshot(jc), te.ctrl_snapshot(tc)
    for name in jc:
        want = np.asarray(jsnap[name]["sim_l"])
        assert tsnap[name]["sim_l"].dtype == want.dtype
        np.testing.assert_array_equal(tsnap[name]["sim_l"], want,
                                      err_msg=name)
    assert te.refresh_modes(tc) == je.refresh_modes(jc)
    assert te.last_mode_events == je.last_mode_events
    assert len(te.last_mode_events) > 0
    assert_caches_match(jc, tc)


def _spec_like(jspec):
    from repro_torch.core.reuse_cache import ReuseSiteSpec

    return ReuseSiteSpec(**dataclasses.asdict(jspec))


def test_mode_mirror_equals_device_lane(rng):
    _, te, _, tc = run_both(rng, 2, steps=3)
    te.set_mode(tc, "qkv", "basic", layer=1)
    te.set_mode(tc, "down", "basic")
    te.refresh_modes(tc)
    te.set_mode(tc, "rag", "reuse", layer=0)
    for name, entry in tc.items():
        np.testing.assert_array_equal(entry["mode_host"],
                                      entry["ctrl"]["mode_id"].numpy())
        assert entry["mode_host"].dtype == np.int8
    # and the dispatch reads it: a basic lane counts a basic evaluation
    te.set_mode(tc, "qkv", "basic")
    before = tc["qkv"]["sensor"]["mode_flag"].clone()
    x = torch.zeros((M, 256))
    te.apply("qkv", x, torch.zeros((256, 384)), None,
             te.layer_view(tc, 0)["qkv"])
    assert int(tc["qkv"]["sensor"]["mode_flag"][0]) == 0
    assert int(before[0]) == 1


def test_ctrl_snapshot_is_one_transfer(monkeypatch, rng):
    _, te, _, tc = run_both(rng, 2, steps=2)
    calls = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    snap = te.ctrl_snapshot(tc)
    assert len(calls) == 1
    assert set(snap) == set(tc)
    assert snap["qkv"]["mode_id"].dtype == np.int8
    assert snap["qkv"]["skipped"] == int(tc["qkv"]["sensor"]["skipped_tiles"].sum())


def test_stacked_cache_leaf_dtypes_and_shapes():
    _, te = build(3)
    tc = te.init_cache(M, device="cpu")
    e = tc["qkv"]
    assert e["prev_q"].shape == (3, M, 256) and e["prev_q"].dtype == torch.int8
    assert e["prev_out"].dtype == torch.float32
    assert e["ctrl"]["mode_id"].dtype == torch.int8
    assert e["ctrl"]["cooldown"].dtype == torch.int32
    assert e["ctrl"]["quarantine"].dtype == torch.int32
    assert e["ctrl"]["sim_threshold"].shape == (3,)
    assert e["mode_host"].shape == (3,)
    assert tc["plain"]["mode_host"].tolist() == [0, 0, 0]
    assert te.sites["down"].dataflow == "input"
    assert te.sites["rag"].exec_path == "ragged"


def test_tuned_table_written_by_reference_loads(tmp_path):
    path = str(tmp_path / "table.json")
    table = {"attn_qkv": JTunables(exec_path="ragged", max_active_k=3,
                                   block_k=128),
             "mlp_in@2": JTunables(sim_threshold=0.4)}
    save_table(path, table, meta={"from": "test"})
    loaded = load_table(path)
    assert {k: v.to_dict() for k, v in loaded.items()} == \
        {k: v.to_dict() for k, v in table.items()}
    pol = load_tuned_policy(path)
    assert pol.resolve("attn_qkv").exec_path == "ragged"
    assert pol.resolve("mlp_in", layer=2).sim_threshold == 0.4


def test_scheduler_completes_all_requests(rng):
    calls = {"prefill": 0, "decode": 0}

    def prefill_fn(prompt, slot):
        calls["prefill"] += 1
        return 1

    def decode_fn(tokens):
        calls["decode"] += 1
        return tokens + 1

    b = ContinuousBatcher(batch_slots=2, prefill_fn=prefill_fn,
                          decode_fn=decode_fn, max_steps=100)
    for i in range(5):
        b.submit(Request(rid=i, prompt=np.zeros(4, np.int32),
                         max_new_tokens=3 + i % 2))
    done = b.run()
    assert len(done) == 5 and all(r.done for r in done)
    assert all(len(r.output) == r.max_new_tokens for r in done)
    assert calls["prefill"] == 5


def test_reset_slot_zeroes_one_lane(rng):
    _, te, _, tc = run_both(rng, 2, steps=2)
    reset_slot(tc, 1)
    for entry in tc.values():
        assert int(entry["prev_q"][:, 1].abs().sum()) == 0
        assert float(entry["prev_out"][:, 1].abs().sum()) == 0.0
        assert float(entry["sim_ema"][:, 1].abs().sum()) == 0.0
        assert int(entry["sensor"]["slot_steps"][:, 1].sum()) == 0
        assert int(entry["sensor"]["slot_steps"][:, 0].sum()) > 0
