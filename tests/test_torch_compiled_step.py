"""The compiled serve step (`repro_torch.serve.compiled_step`) on the CPU.

On the CPU `CompiledStep` runs the function each variant would capture
directly, with the same static buffers and the same variant bookkeeping as
on the card, so its logic is tested here:

  - against the JAX package's jitted prefill and jitted, donated decode
    variants (one per spec signature, as `repro.launch.serve` keeps them),
    across a forced mode flip (`set_mode`) and a spec change
    (`apply_tunables`), at the tolerances of tests/test_torch_serve.py:
    logits within rtol 1e-4 / atol 1e-4 (the same f32 products summed in
    another order), greedy tokens equal, caches by `assert_caches_match`;
  - bitwise against the plain `prefill_step` / `decode_step` across slot
    recycling and policy refreshes;
  - every state and cache tensor keeps its storage (a graph holds pointers);
  - variants are built only for unseen keys; a budget move keeps the
    decode key (the accounting reads the engine's budget lanes) with the
    reference's counters; past the cap the least recently used decode
    variant is evicted, and a recurring key is built again;
  - the step functions copy no host data to the device and read no device
    value on the host (`lift_fresh`, `_local_scalar_dense`), either of
    which would break a capture on the card;
  - launch accounting under replay.

Reduced models in f32 with `block_k=64` (gk >= 2, so tiles skip).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.policy import SiteTunables as JTunables
from repro.models import init_params as jinit_params
from repro.serve import serve_step as jserve
from repro_torch.core.policy import SiteTunables
from repro_torch.kernels import backend, ops
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import params_from_numpy
from repro_torch.serve import serve_step as tserve
from repro_torch.serve.compiled_step import CompiledStep, Variant, summary_line
from repro_torch.serve.scheduler import ContinuousBatcher, Request, reset_slot
from test_torch_engine import assert_caches_match
from test_torch_serve import configs as qwen3_configs
from test_torch_ssm import configs as rwkv6_configs
from test_torch_ssm import random_rwkv_tree

B, PROMPT, CACHE, STEPS = 2, 8, 32, 6
FLIP_MODE_AT, FLIP_SPEC_AT = 2, 4

CASES = [("qwen3-32b", "default"), ("qwen3-32b", "input_stationary"),
         ("qwen3-32b", "ragged"), ("rwkv6-7b", "default")]


def models(rng, arch, variant):
    """(jcfg, tcfg, jpol, tpol, jparams, tparams) of a reduced model."""
    if arch == "rwkv6-7b":
        jcfg, tcfg, jpol, tpol = rwkv6_configs(variant)
        tree = jax.tree.map(np.asarray,
                            jinit_params(jcfg, jax.random.PRNGKey(0)))
        tree["blocks"]["rwkv"] = random_rwkv_tree(rng, tree["blocks"]["rwkv"])
    else:
        jcfg, tcfg, jpol, tpol = qwen3_configs(variant)
        tree = jax.tree.map(np.asarray,
                            jinit_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jpol, tpol, jparams, params_from_numpy(tree, tcfg, "cpu")


def compiled(tparams, tcfg, tpol, batch=B):
    engine = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64,
                                       policy=tpol)
    state = tserve.init_serve_state(tcfg, batch, CACHE, device="cpu")
    step = CompiledStep(tparams, tcfg, state, batch=batch, engine=engine,
                        rcache=engine.init_cache(batch, device="cpu"),
                        graphs=False)
    return step, engine


def first_site(engine):
    return next(iter(engine.sites))


def flip_site(engine):
    """attn_out (dense) or rwkv_wo: a site after the first kernel."""
    return "attn_out" if "attn_out" in engine.sites else "rwkv_wo"


@pytest.mark.parametrize("arch,variant", CASES)
def test_compiled_serve_matches_jax(rng, arch, variant):
    jcfg, tcfg, jpol, tpol, jparams, tparams = models(rng, arch, variant)
    prompts = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)

    jeng = jserve.build_reuse_engine(jcfg, impl="pallas", block_k=64,
                                     policy=jpol)
    jstate, jrc = jserve.init_serve_state(jcfg, B, CACHE), jeng.init_cache(B)
    jit_prefill = jax.jit(lambda p, t, s: jserve.prefill_step(p, jcfg, t, s))
    decode_variants = {}

    def jdecode():
        # the reference's variants: keyed on the spec signature, the serving
        # state and the reuse cache donated
        key = tuple(sorted(jeng.sites.items()))
        if key not in decode_variants:
            decode_variants[key] = jax.jit(
                lambda p, t, s, rc: jserve.decode_step(
                    p, jcfg, t, s, engine=jeng, reuse_cache=rc),
                donate_argnums=(2, 3))
        return decode_variants[key]

    step, teng = compiled(tparams, tcfg, tpol)
    jlog, jstate = jit_prefill(jparams, jnp.asarray(prompts), jstate)
    tlog = step.prefill(prompts)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = np.array(jserve.greedy_sample(jlog))
    for i in range(STEPS):
        if i == FLIP_MODE_AT:
            for eng, rc in ((jeng, jrc), (teng, step.rcache)):
                eng.set_mode(rc, flip_site(teng), "basic", layer=0)
        if i == FLIP_SPEC_AT:
            site = first_site(teng)
            assert jeng.apply_tunables(site, JTunables(block_k=32), jrc)
            assert teng.apply_tunables(site, SiteTunables(block_k=32),
                                       step.rcache)
        jlog, jstate, jrc = jdecode()(jparams, jnp.asarray(tok), jstate, jrc)
        tlog = step.decode(tok)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tserve.greedy_sample(tlog).numpy(),
                                      np.asarray(jserve.greedy_sample(jlog)))
    assert len(decode_variants) == 2
    # prefill, then decode at the start, after the mode flip, after the spec
    # change
    assert step.captures == 4
    assert int(step.state["len"]) == int(jstate["len"]) == PROMPT + STEPS
    assert_caches_match(jrc, step.rcache)
    assert sum(int(e["sensor"]["skipped_tiles"].sum())
               for e in step.rcache.values()) > 0


def run_batcher(prefill_fn, decode_fn, on_retire, on_step, prompts, max_new):
    batcher = ContinuousBatcher(
        batch_slots=B, prefill_fn=prefill_fn, decode_fn=decode_fn,
        max_steps=64, on_retire=on_retire, on_step=on_step)
    for rid, p in enumerate(prompts):
        batcher.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    return {r.rid: r.output for r in batcher.run()}


def serve_both_ways(rng, arch, variant, n_requests=5, max_new=4):
    """Serve the same requests through the plain steps (fresh state dicts
    adopted from each call, as an uncompiled serve does) and through a
    CompiledStep, with a policy refresh every 2 steps. Returns both runs'
    (outputs, logits, state, reuse cache, step)."""
    _, tcfg, _, tpol, _, tparams = models(rng, arch, variant)
    prompts = [rng.integers(0, tcfg.vocab, (PROMPT,)).astype(np.int32)
               for _ in range(n_requests)]
    runs = []
    for how in ("plain", "compiled"):
        step, engine = compiled(tparams, tcfg, tpol)
        st = {"state": step.state, "rcache": step.rcache}
        logits = []

        def prefill_fn(prompt, slot):
            full = np.zeros((B, PROMPT), np.int32)
            full[slot] = prompt[0]
            if how == "plain":
                lg, st["state"] = tserve.prefill_step(
                    tparams, tcfg, torch.from_numpy(full), st["state"])
            else:
                lg = step.prefill(full)
            reset_slot(st["rcache"], slot)
            logits.append(lg.clone())
            return int(tserve.greedy_sample(lg[slot:slot + 1, -1:])[0, 0])

        def decode_fn(tokens):
            if how == "plain":
                lg, st["state"], st["rcache"] = tserve.decode_step(
                    tparams, tcfg, torch.from_numpy(tokens.copy()),
                    st["state"], engine=engine, reuse_cache=st["rcache"])
            else:
                lg = step.decode(tokens)
            logits.append(lg.clone())
            return tserve.greedy_sample(lg).numpy()

        def on_step(i):
            if i % 2 == 0:
                engine.refresh_modes(st["rcache"])

        outputs = run_batcher(
            prefill_fn, decode_fn,
            lambda req: reset_slot(st["rcache"], req.slot), on_step,
            prompts, max_new)
        runs.append((outputs, logits, st["state"], st["rcache"], step))
    return runs


def tensors(tree, prefix=""):
    """{path: tensor} of every tensor leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tensors(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,variant", [
    ("qwen3-32b", "default"), ("qwen3-32b", "ragged"),
    ("rwkv6-7b", "default")])
def test_compiled_path_is_bitwise_the_plain_steps(rng, arch, variant):
    (out_p, log_p, st_p, rc_p, _), (out_c, log_c, st_c, rc_c, step) = \
        serve_both_ways(rng, arch, variant)
    assert len(out_c) == 5 and out_c == out_p
    assert len(log_c) == len(log_p)
    for a, b in zip(log_p, log_c):
        assert torch.equal(a, b)
    for want, got in ((tensors(st_p), tensors(st_c)),
                      (tensors(rc_p), tensors(rc_c))):
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
    for name in rc_p:
        np.testing.assert_array_equal(rc_p[name]["mode_host"],
                                      rc_c[name]["mode_host"])
    assert step.summary()["prefill"] == 1


def pointers(step):
    ptrs = {f"state.{k}": t.data_ptr() for k, t in tensors(step.state).items()}
    ptrs.update({f"rcache.{k}": t.data_ptr()
                 for k, t in tensors(step.rcache).items()})
    ptrs["tokens"] = step.tokens.data_ptr()
    ptrs.update({f"prompt{s}": t.data_ptr() for s, t in step.prompts.items()})
    return ptrs


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_buffers_stay_in_place(rng, arch):
    _, tcfg, _, tpol, _, tparams = models(rng, arch, "default")
    step, engine = compiled(tparams, tcfg, tpol)
    state, rcache = step.state, step.rcache
    prompts = rng.integers(0, tcfg.vocab, (B, PROMPT)).astype(np.int32)
    step.prefill(prompts)
    ptrs = pointers(step)
    assert len(ptrs) > 20
    tok = np.zeros((B, 1), np.int32)
    for act in ("reset_slot", "decode", "decode", "refresh_modes", "decode",
                "set_mode", "decode", "prefill"):
        if act == "reset_slot":
            reset_slot(rcache, 1)
        elif act == "decode":
            step.decode(tok)
        elif act == "refresh_modes":
            engine.refresh_modes(rcache)
        elif act == "set_mode":
            engine.set_mode(rcache, flip_site(engine), "basic")
        else:
            step.prefill(prompts)
        assert step.state is state and step.rcache is rcache
        assert pointers(step) == ptrs, act
    assert int(state["len"]) == 2 * PROMPT + 4


def test_variants_are_built_only_for_unseen_keys(rng):
    _, tcfg, _, tpol, _, tparams = models(rng, "qwen3-32b", "default")
    step, engine = compiled(tparams, tcfg, tpol)
    tok = np.zeros((B, 1), np.int32)
    step.prefill(rng.integers(0, tcfg.vocab, (B, PROMPT)).astype(np.int32))
    step.prefill(rng.integers(0, tcfg.vocab, (B, PROMPT)).astype(np.int32))
    assert step.captures == 1
    step.decode(tok)
    assert step.captures == 2
    step.decode(tok)
    assert step.captures == 2
    key0 = step.decode_key()
    engine.set_mode(step.rcache, "attn_out", "basic", layer=1)   # mode flip
    assert step.decode_key()[1] == key0[1] and step.decode_key() != key0
    step.decode(tok)
    assert step.captures == 3
    engine.set_mode(step.rcache, "attn_out", "reuse", layer=1)   # flip back
    assert step.decode_key() == key0
    step.decode(tok)
    assert step.captures == 3
    assert engine.apply_tunables("mlp_in", SiteTunables(block_k=32),
                                 step.rcache)                     # exec flip
    step.decode(tok)
    assert step.captures == 4
    s = step.summary()
    assert (s["variants"], s["decode"], s["prefill"]) == (4, 3, 1)
    # a pinned site's mirror is not part of the key: its branch is static
    engine.sites["mlp_out"] = dataclasses.replace(engine.sites["mlp_out"],
                                                  mode="reuse")
    key = step.decode_key()
    engine.set_mode(step.rcache, "mlp_out", "basic")
    assert step.decode_key() == key


def test_budget_move_keeps_the_decode_key(rng):
    """On the ragged variant, a budget-only `set_budget` between steps
    keeps the decode key (no capture), writes the site's budget lane in
    place, and the sensor counters stay bitwise the reference's jitted
    decode with the same move (overflow fallbacks and grid steps read the
    new budget)."""
    jcfg, tcfg, jpol, tpol, jparams, tparams = models(rng, "qwen3-32b",
                                                      "ragged")
    prompts = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jeng = jserve.build_reuse_engine(jcfg, impl="pallas", block_k=64,
                                     policy=jpol)
    jstate, jrc = jserve.init_serve_state(jcfg, B, CACHE), jeng.init_cache(B)
    jlog, jstate = jax.jit(lambda p, t, s: jserve.prefill_step(
        p, jcfg, t, s))(jparams, jnp.asarray(prompts), jstate)
    step, teng = compiled(tparams, tcfg, tpol)
    step.prefill(prompts)
    lane = teng.budget_lanes["attn_qkv"]
    ptr = lane.data_ptr()
    tok = np.array(jserve.greedy_sample(jlog))
    keys = []
    for i in range(STEPS):
        if i in (2, 4):
            budget = 2 if i == 2 else 1
            for eng in (jeng, teng):
                assert all(eng.set_budget(s, budget) for s in
                           ("attn_qkv", "mlp_in"))
            assert int(lane) == budget and lane.data_ptr() == ptr
        jlog, jstate, jrc = jax.jit(lambda p, t, s, rc: jserve.decode_step(
            p, jcfg, t, s, engine=jeng, reuse_cache=rc))(
                jparams, jnp.asarray(tok), jstate, jrc)
        step.decode(tok)
        keys.append(step.decode_key())
        assert step.last_built == (i == 0)
        tok = np.array(jserve.greedy_sample(jlog))
    assert len(set(keys)) == 1 and step.captures == 2
    assert teng.sites["attn_qkv"].max_active_k == 1
    assert_caches_match(jrc, step.rcache)
    assert int(step.rcache["attn_qkv"]["sensor"]["overflow_fallbacks"]
               .sum()) > 0


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_decode_variants_are_bounded_least_recently_used_first(rng, cap):
    """Decode keys A, B, C, A, C, D through a CompiledStep capped at `cap`
    live decode variants: past the cap the least recently used one is
    evicted (never a prefill variant), a recurring key that was evicted is
    built again, and the summary counts what was built, what lives and
    what was evicted."""
    _, tcfg, _, tpol, _, tparams = models(rng, "qwen3-32b", "default")
    engine = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64,
                                       policy=tpol)
    state = tserve.init_serve_state(tcfg, B, CACHE, device="cpu")
    step = CompiledStep(tparams, tcfg, state, batch=B, engine=engine,
                        rcache=engine.init_cache(B, device="cpu"),
                        graphs=False, max_decode_variants=cap)
    step.prefill(rng.integers(0, tcfg.vocab, (B, PROMPT)).astype(np.int32))
    tok = np.zeros((B, 1), np.int32)
    layer_mode = {"A": None, "B": 0, "C": 1, "D": (0, 1)}
    built, live = [], []
    for name in "ABCACD":
        for layer in range(2):
            engine.set_mode(step.rcache, "attn_out", "reuse", layer=layer)
        want = layer_mode[name]
        for layer in ([want] if isinstance(want, int) else want or ()):
            engine.set_mode(step.rcache, "attn_out", "basic", layer=layer)
        step.decode(tok)
        built.append(step.last_built)
        live.append(step.live_decode())
        assert step.live_decode() <= cap
        assert step.summary()["prefill"] == 1
    # the order A B C A C D: which calls built a variant at each cap
    want_built = {1: [True] * 6,
                  2: [True, True, True, True, False, True],
                  3: [True, True, True, False, False, True]}[cap]
    assert built == want_built
    s = step.summary()
    assert s["decode"] == sum(built) and s["live_decode"] == min(cap, 4)
    assert s["evictions"] == sum(built) - s["live_decode"]
    assert s["captures"] == s["decode"] + 1 and s["decode_cap"] == cap
    assert (f"live {s['live_decode']} decode variants (cap {cap}), "
            f"{s['evictions']} evictions") in summary_line(s)
    assert ("prefill", (B, PROMPT)) in step.variants


def test_replay_under_another_key_raises(rng):
    _, tcfg, _, tpol, _, tparams = models(rng, "qwen3-32b", "default")
    step, _ = compiled(tparams, tcfg, tpol)

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    v = Variant(("decode", (), ()), Graph(), torch.zeros(1),
                collections.Counter())
    with pytest.raises(RuntimeError, match="another key"):
        step.replay(v, step.decode_key())
    assert Graph.replays == 0
    with pytest.raises(ValueError, match="CUDA device"):
        CompiledStep(tparams, tcfg, step.state, batch=B, graphs=True)


class NoHostTraffic(TorchDispatchMode):
    """Fails on a device value read on the host (`_local_scalar_dense`) and on
    host data copied into a new tensor (`lift_fresh`)."""

    BANNED = ("aten._local_scalar_dense", "aten.lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.BANNED):
            raise AssertionError(f"{func} in the step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
@pytest.mark.parametrize("path,mode", [("default", "reuse"),
                                       ("ragged", "reuse"),
                                       ("default", "basic"),
                                       ("prefill", None)])
def test_step_functions_have_no_host_traffic(rng, arch, path, mode):
    variant = "ragged" if path == "ragged" else "default"
    _, tcfg, _, tpol, _, tparams = models(rng, arch, variant)
    step, engine = compiled(tparams, tcfg, tpol)
    prompts = rng.integers(0, tcfg.vocab, (B, PROMPT)).astype(np.int32)
    step.prefill(prompts)
    step.decode(np.ones((B, 1), np.int32))
    if path == "prefill":
        with torch.no_grad(), NoHostTraffic():
            step.run_prefill(step.prompts[(B, PROMPT)])
        return
    if mode == "basic":
        for name in engine.sites:
            engine.set_mode(step.rcache, name, "basic")
    step.tokens.fill_(3)
    with torch.no_grad(), NoHostTraffic():
        step.run_decode()
    assert int(step.state["len"]) == PROMPT + 2


def test_the_host_traffic_check_catches_a_copy():
    with pytest.raises(AssertionError, match="lift_fresh"):
        with NoHostTraffic():
            torch.tensor(1.0)


def test_recorded_launches_are_counted_once_per_replay():
    backend.reset_launches()
    backend.count_launch("delta_quant")             # the eager first step
    with backend.recorded_launches() as rec:        # the capture
        backend.count_launch("delta_quant")
        backend.count_launch("wkv6_decode")
        assert backend.launch_counts()["wkv6_decode"] == 1
    counts = backend.launch_counts()
    assert counts["delta_quant"] == 1 and counts["wkv6_decode"] == 0
    assert rec == {"delta_quant": 1, "wkv6_decode": 1}
    for _ in range(3):
        backend.count_replay(rec)
    counts = backend.launch_counts()
    assert counts["delta_quant"] == 4 and counts["wkv6_decode"] == 3
    with pytest.raises(KeyError):
        with backend.recorded_launches():
            backend.count_launch("delta_quant")
            raise KeyError("a failed capture")
    assert backend.launch_counts()["delta_quant"] == 4
    backend.reset_launches()


def test_serve_counts_equal_with_and_without_eager(monkeypatch, capsys):
    """On the CPU the wrappers take their plain versions and count nothing;
    here the ops entry points count as their kernels would, so the compiled
    serve's counts can be held against the eager serve's."""
    names = {"delta_quant_account": lambda kw: "delta_quant_account",
             "reuse_matmul": lambda kw: f"reuse_matmul_{kw['dataflow']}",
             "reuse_matmul_ragged": lambda kw: "reuse_matmul_ragged",
             "wkv6_decode": lambda kw: "wkv6_decode"}
    for fn, kname in names.items():
        orig = getattr(ops, fn)

        def counting(*a, _orig=orig, _kname=kname, **kw):
            backend.count_launch(_kname(kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, fn, counting)
    counts, lines = {}, {}
    for eager in (True, False):
        backend.reset_launches()
        argv = ["--arch", "rwkv6-7b", "--reduced", "--requests", "3",
                "--batch-slots", "2", "--prompt-len", "4", "--max-new", "3",
                "--reuse", "--refresh-every", "2", "--device", "cpu"]
        tserve_cli.main(argv + ["--eager"] * eager)
        counts[eager] = backend.launch_counts()
        out = capsys.readouterr().out
        lines[eager] = [ln for ln in out.splitlines()
                        if ln.startswith(("SensorReport", "  rwkv"))]
    backend.reset_launches()
    assert counts[True] == counts[False]
    assert counts[True]["delta_quant_account"] > 0 and \
        counts[True]["wkv6_decode"] > 0
    assert lines[True] == lines[False] and len(lines[True]) >= 4
