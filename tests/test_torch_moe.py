"""The port's MoE family (`repro_torch.models.moe`, `core.expert_reuse`, the
sliding-window rolling KV cache, mixtral-8x7b and llama4-scout-17b-a16e)
against the JAX package's, on the CPU.

Reduced configs run in f32 with the reference's weights carried over by
`params_from_numpy`. Outputs and caches agree within atol 1e-5 + rtol 1e-5
(the same f32 products summed in another order); chosen experts, keep
masks, expert slots, int8 codes, skip statistics and every sensor counter
are equal. The serves and the measured-decode runner are held against the
reference's own: the port on the reference's serve tier (impl "jnp") gives
equal tokens and equal JSONL rows; on its kernel tier the rows differ only
in exec_path ("kernel" against "dense").
"""

import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import expert_reuse as jer
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models.layers import apply_norm as japply_norm
from repro.quant import dequantize_int8 as jdequant
from repro.quant import quantize_int8 as jquant
from repro.sensor import runner as jrunner
from repro.serve import serve_step as jserve
from repro_torch.configs import ARCHS
from repro_torch.core import expert_reuse as ter
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import init_decode_state, init_params
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from repro_torch.models.transformer import check_family
from repro_torch.sensor import runner as trunner
from repro_torch.serve import serve_step as tserve
from repro_torch.serve.compiled_step import CompiledStep
from test_torch_compiled_step import NoHostTraffic
from test_torch_engine import assert_caches_match
from test_torch_measured import assert_rows_match

ATOL = RTOL = 1e-5
MOE_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def moe_block(arch, **changes):
    """(jcfg, tcfg, reference moe params, the port's copy) of one reduced
    MoE block."""
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **changes)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), **changes)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def reference_dispatch(jp, jcfg, x):
    """The reference moe_forward's routing and dispatch, line for line:
    (top_e, flat keep, flat slot)."""
    b, s, d = x.shape
    h = japply_norm(jp["norm"], x, jcfg.norm_eps).reshape(b * s, d)
    gates = jax.nn.softmax(h.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(gates, jcfg.top_k)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    cap = jmoe._capacity(jcfg, b * s)
    keep = pos_in_e < cap
    return (np.asarray(top_e), np.asarray(keep),
            np.asarray(jnp.where(keep, pos_in_e, cap)))


MOE_CASES = {
    "mixtral_top2": ("mixtral-8x7b", {}, (2, 16)),
    "llama4_top1_shared": ("llama4-scout-17b-a16e", {}, (2, 16)),
    "mixtral_capacity_drop": ("mixtral-8x7b", {"capacity_factor": 0.5},
                              (4, 16)),
    "llama4_capacity_drop": ("llama4-scout-17b-a16e",
                             {"capacity_factor": 0.5}, (4, 16)),
    "mixtral_decode_batch": ("mixtral-8x7b", {}, (8, 1)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(rng, case):
    arch, changes, (b, s) = MOE_CASES[case]
    jcfg, tcfg, jp, tp = moe_block(arch, **changes)
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    want = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    close(t2n(got), want)

    # the same experts, keep mask and expert slots
    top_e, keep, slot = reference_dispatch(jp, jcfg, jnp.asarray(x))
    h = tmoe.apply_norm(tp["norm"], torch.from_numpy(x),
                        tcfg.norm_eps).reshape(b * s, -1)
    t_e, t_g = tmoe.route(tp, tcfg, h)
    np.testing.assert_array_equal(t2n(t_e), top_e)
    cap = tmoe._capacity(tcfg, b * s)
    assert cap == jmoe._capacity(jcfg, b * s)
    _, flat_g, t_slot, t_keep = tmoe.dispatch(t_e, t_g, tcfg.n_experts, cap)
    np.testing.assert_array_equal(t2n(t_keep), keep)
    np.testing.assert_array_equal(t2n(t_slot), slot)
    assert not t2n(flat_g)[~keep].any()
    if "capacity_drop" in case:
        assert not keep.all()   # the case drops tokens
    else:
        assert keep.all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropless_moe_equals_the_dense_expert_sum(rng, arch):
    """capacity_factor = n_experts keeps every token: the dispatch equals
    every expert evaluated densely and combined with the top-k gates."""
    jcfg, tcfg, _, tp = moe_block(arch, capacity_factor=4.0)
    b, s, d = 2, 8, tcfg.d_model
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    got = tmoe.moe_forward(tp, tcfg, x).reshape(-1, d)
    h = tmoe.apply_norm(tp["norm"], x, tcfg.norm_eps).reshape(-1, d)
    top_e, top_g = tmoe.route(tp, tcfg, h)
    ref = torch.zeros((b * s, d))
    for e in range(tcfg.n_experts):
        g, u = torch.chunk(h @ tp["wi"][e], 2, dim=-1)
        ye = (torch.nn.functional.silu(g) * u) @ tp["wo"][e]
        for kk in range(tcfg.top_k):
            ref = ref + ye * torch.where(top_e[:, kk] == e, top_g[:, kk],
                                         0.0)[:, None]
    if tcfg.shared_expert:
        g, u = torch.chunk(h @ tp["shared_wi"], 2, dim=-1)
        ref = ref + (torch.nn.functional.silu(g) * u) @ tp["shared_wo"]
    close(t2n(got), t2n(ref))


# ------------------------------------------------------------ expert reuse

def expert_reuse_stream(rng, b=4, steps=8):
    """The reference test's stream: a drifting input (routing switches),
    then a repeat of the last step."""
    d = ARCHS["mixtral-8x7b"].reduced().d_model
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    xs = []
    for _ in range(steps):
        x = x + 0.3 * rng.normal(size=(b, 1, d)).astype(np.float32)
        xs.append(x)
    xs.append(xs[-1])
    return xs


def dense_top1(jp, jcfg, x, scale, act_scale):
    """The quantized dense top-1 MoE the reuse lanes must equal (the
    reference test's `dense_reference`)."""
    b, _, d = x.shape
    h = japply_norm(jp["norm"], x, jcfg.norm_eps).reshape(b, d)
    logits = h.astype(jnp.float32) @ jp["router"]
    top_e = jnp.argmax(logits, axis=-1)
    gate = jax.nn.softmax(logits, axis=-1)[jnp.arange(b), top_e]
    hq = jdequant(jquant(h, scale), scale)
    hi = jnp.einsum("bd,bdf->bf", hq, jp["wi"][top_e].astype(jnp.float32))
    g, u = jnp.split(hi, 2, axis=-1)
    actq = jdequant(jquant(jax.nn.silu(g) * u, act_scale), act_scale)
    out = jnp.einsum("bf,bfd->bd", actq, jp["wo"][top_e].astype(jnp.float32))
    return (out * gate[:, None]).reshape(b, 1, d)


def test_moe_reuse_forward_matches_reference_over_switches(rng):
    jcfg, tcfg, jp, tp = moe_block("mixtral-8x7b", top_k=1)
    b = 4
    jc = jer.layer_slice(jer.init_expert_reuse_cache(jcfg, b), 0)
    stacked = ter.init_expert_reuse_cache(tcfg, b, device="cpu")
    tc = ter.layer_slice(stacked, 0)
    assert stacked["prev_q"].shape == (tcfg.n_superblocks,
                                       tcfg.n_experts, b, tcfg.d_model)
    lanes = set()
    for i, x in enumerate(expert_reuse_stream(rng, b)):
        jout, jc, js = jer.moe_reuse_forward(jp, jcfg, jnp.asarray(x), jc,
                                             block_k=32)
        tout, tc2, ts = ter.moe_reuse_forward(tp, tcfg, torch.from_numpy(x),
                                              tc, block_k=32)
        assert tc2 is tc
        close(t2n(tout), jout)
        close(t2n(tout), dense_top1(jp, jcfg, jnp.asarray(x), jc["scale"],
                                    jc["act_scale"]), atol=5e-3, rtol=5e-3)
        for k in ("prev_q", "prev_act_q"):
            np.testing.assert_array_equal(t2n(tc[k]), np.asarray(jc[k]), k)
        for k in ("prev_hi", "prev_out"):
            close(t2n(tc[k]), jc[k])
        assert [float(v) for v in ts] == [float(v) for v in js]
        h = japply_norm(jp["norm"], jnp.asarray(x), jcfg.norm_eps)
        lanes |= set(np.asarray(jnp.argmax(
            h.reshape(b, -1) @ jp["router"], -1)).tolist())
        if i == 0:
            assert float(ts.wi_skip) == 0.0   # cold lanes
    assert len(lanes) > 1                     # the stream switched experts
    # the last step repeats its input: every slot skips everything
    assert float(ts.sticky_fraction) == float(ts.wi_skip) == \
        float(ts.wo_skip) == 1.0
    # the layer view writes into the stacked cache
    assert stacked["prev_q"][0].abs().sum() > 0


# ----------------------------------------------- the sliding-window cache

def reduced_model(arch, **changes):
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **changes)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), **changes)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def window_decode():
    """Reduced mixtral (window 64) with cache_len == window: a 48-token
    prefill, then 24 decode steps with reuse (the reference's serve tier on
    both sides), so the last 8 write rolled slots. Dropless
    (capacity_factor = n_experts), so a prefill of the same tokens routes
    every token as the decode steps do."""
    jcfg, tcfg, jparams, tparams = reduced_model("mixtral-8x7b",
                                                 capacity_factor=4.0)
    b, prompt, cache, steps = 2, 48, jcfg.window, 24
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab, (b, prompt)).astype(np.int32)
    jstate = jserve.init_serve_state(jcfg, b, cache)
    tstate = tserve.init_serve_state(tcfg, b, cache, device="cpu")
    jlog, jstate = jax.jit(lambda p, t, s: jserve.prefill_step(p, jcfg, t, s))(
        jparams, jnp.asarray(prompts), jstate)
    tlog, tstate = tserve.prefill_step(tparams, tcfg,
                                       torch.from_numpy(prompts), tstate)
    jeng = jserve.build_reuse_engine(jcfg, impl="jnp", block_k=64)
    teng = tserve.build_reuse_engine(tcfg, impl="jnp", block_k=64)
    jrc, trc = jeng.init_cache(b), teng.init_cache(b, device="cpu")
    jdecode = jax.jit(lambda p, t, s, rc: jserve.decode_step(
        p, jcfg, t, s, engine=jeng, reuse_cache=rc))
    logits, kv = [(t2n(tlog), np.asarray(jlog))], []
    tokens = [prompts]
    tok = np.array(jserve.greedy_sample(jlog))
    for _ in range(steps):
        tokens.append(tok)
        jlog, jstate, jrc = jdecode(jparams, jnp.asarray(tok), jstate, jrc)
        tlog, tstate, trc = tserve.decode_step(
            tparams, tcfg, torch.from_numpy(tok), tstate, engine=teng,
            reuse_cache=trc)
        logits.append((t2n(tlog), np.asarray(jlog)))
        kv.append({k: (t2n(tstate["blocks"][k]).copy(),
                       np.asarray(jstate["blocks"][k])) for k in ("k", "v")})
        tok = np.array(jserve.greedy_sample(jlog))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                logits=logits, kv=kv, tokens=np.concatenate(tokens, 1),
                jrc=jrc, trc=trc, tstate=tstate, jstate=jstate)


def test_decode_past_the_window_matches_reference(window_decode):
    w = window_decode
    cache = w["jcfg"].window
    assert w["tstate"]["blocks"]["k"].shape[2] == cache
    assert int(w["tstate"]["len"]) == int(w["jstate"]["len"]) == 72 > cache
    for tl, jl in w["logits"]:
        close(tl, jl)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    for step in w["kv"]:
        for tk, jk in step.values():
            close(tk, jk)
    assert_caches_match(w["jrc"], w["trc"])


def test_windowed_prefill_writes_the_rolled_cache(window_decode):
    """A prefill of all 72 tokens into a fresh 64-slot cache writes token t
    at slot t % 64, as the reference's does, and holds, slot for slot, what
    a plain decode (no reuse) of the same tokens past the window leaves
    there."""
    w = window_decode
    jcfg, tcfg, tokens = w["jcfg"], w["tcfg"], w["tokens"]
    b, cache, prompt = tokens.shape[0], jcfg.window, 48
    jstate = jserve.init_serve_state(jcfg, b, cache)
    tstate = tserve.init_serve_state(tcfg, b, cache, device="cpu")
    jlog, jstate = jserve.prefill_step(w["jparams"], jcfg,
                                       jnp.asarray(tokens), jstate)
    tlog, tstate = tserve.prefill_step(w["tparams"], tcfg,
                                       torch.from_numpy(tokens), tstate)
    close(t2n(tlog), jlog)
    dstate = tserve.init_serve_state(tcfg, b, cache, device="cpu")
    _, dstate = tserve.prefill_step(w["tparams"], tcfg,
                                    torch.from_numpy(tokens[:, :prompt]),
                                    dstate)
    for i in range(prompt, tokens.shape[1]):
        dlog, dstate, _ = tserve.decode_step(
            w["tparams"], tcfg, torch.from_numpy(tokens[:, i:i + 1]), dstate)
    close(t2n(dlog), t2n(tlog), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        close(t2n(tstate["blocks"][k]), jstate["blocks"][k])
        # a slot holding another position would differ by the values
        # themselves; the same position differs by f32 summation order
        dec, pre = t2n(dstate["blocks"][k]), t2n(tstate["blocks"][k])
        err = np.linalg.norm(dec - pre, axis=-1) / np.linalg.norm(pre,
                                                                 axis=-1)
        assert err.max() < 1e-4, err.max()


def test_decode_slot_rolls_only_when_the_window_fits(rng):
    """Decode writes slot len % cache_len on a rolling cache and clamps at
    cache_len - 1 when the window is longer than the cache."""
    from repro_torch.models.layers import attention_forward

    tcfg = ARCHS["mixtral-8x7b"].reduced()
    tp = init_params(dataclasses.replace(tcfg, n_layers=1), 0, device="cpu")
    ap = {k: v[0] if isinstance(v, torch.Tensor) else
          {kk: vv[0] for kk, vv in v.items()}
          for k, v in tp["blocks"]["attn"].items()}
    x = torch.from_numpy(rng.normal(size=(1, 1, tcfg.d_model))
                         .astype(np.float32))
    for cache_len, length, slot in ((16, 21, 5), (64, 70, 6), (8, 21, 7)):
        window = 16 if cache_len != 8 else 64
        kv = {k: torch.zeros((1, cache_len, tcfg.n_kv_heads, tcfg.head_dim))
              for k in ("k", "v")}
        attention_forward(ap, tcfg, x, layer_window=window,
                          positions=torch.tensor([[length]]), kv_cache=kv,
                          kv_len=torch.tensor(length, dtype=torch.int32))
        written = kv["k"].abs().sum(dim=(0, 2, 3)).nonzero().flatten()
        assert written.tolist() == [slot]


# ------------------------------------------------------------ the family

def test_check_family_takes_the_two_moe_configs_and_no_other():
    for arch in MOE_ARCHS:
        for cfg in (ARCHS[arch], ARCHS[arch].reduced()):
            check_family(cfg)
    from repro_torch.configs.base import ModelConfig

    # every reference config is registered; of the others only the
    # encoder is refused
    assert set(ARCHS) == set(JARCHS)
    for name in JARCHS:
        cfg = ModelConfig(**dataclasses.asdict(JARCHS[name]))
        if JARCHS[name].family == "audio":
            with pytest.raises(NotImplementedError, match="rwkv6"):
                check_family(cfg)
        else:
            check_family(cfg)
    with pytest.raises(NotImplementedError):
        check_family(dataclasses.replace(ARCHS["mixtral-8x7b"],
                                         mlp_kind="gelu"))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_and_state_match_the_reference_layout(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = init_params(tcfg, 0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: str(a.dtype).removeprefix("torch."),
                        tp) == jax.tree.map(lambda a: str(a.dtype), jp)
    # the router stays f32 at full width; the experts take the config's
    # dtype
    full = dataclasses.replace(ARCHS[arch], n_layers=1, d_model=64,
                               d_ff=32, vocab=64, n_heads=2, n_kv_heads=1)
    fp = init_params(full, 0, device="cpu")["blocks"]["moe"]
    assert fp["router"].dtype == torch.float32
    assert fp["wi"].dtype == fp["wo"].dtype == torch.bfloat16
    for cache_len in (16, 128):
        jst = jserve.init_serve_state(jcfg, 2, cache_len)
        tst = init_decode_state(tcfg, 2, cache_len, device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), tst) == jax.tree.map(
            lambda a: tuple(a.shape), jst)


# -------------------------------------------- the compiled step, directly

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_compiled_moe_step_is_bitwise_the_plain_steps(rng, arch):
    _, tcfg, _, tparams = reduced_model(arch)
    b, prompt, cache = 2, 8, 24
    prompts = rng.integers(0, tcfg.vocab, (b, prompt)).astype(np.int32)
    runs = []
    for compiled in (True, False):
        eng = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64)
        rc = eng.init_cache(b, device="cpu")
        state = tserve.init_serve_state(tcfg, b, cache, device="cpu")
        logits = []
        if compiled:
            step = CompiledStep(tparams, tcfg, state, batch=b, engine=eng,
                                rcache=rc, graphs=False)
            logits.append(step.prefill(prompts).clone())
        else:
            lg, state = tserve.prefill_step(tparams, tcfg,
                                            torch.from_numpy(prompts), state)
            logits.append(lg)
        tok = np.ones((b, 1), np.int32)
        for _ in range(4):
            if compiled:
                lg = step.decode(tok).clone()
            else:
                lg, state, rc = tserve.decode_step(
                    tparams, tcfg, torch.from_numpy(tok), state, engine=eng,
                    reuse_cache=rc)
            logits.append(lg)
            tok = t2n(tserve.greedy_sample(lg))[:, :1]
        runs.append((logits, state, rc))
    (lc, sc, rcc), (lp, sp, rcp) = runs
    assert all(torch.equal(a, b) for a, b in zip(lc, lp))
    assert torch.equal(sc["blocks"]["k"], sp["blocks"]["k"])
    assert torch.equal(sc["blocks"]["v"], sp["blocks"]["v"])
    for name in rcc:
        assert torch.equal(rcc[name]["prev_out"], rcp[name]["prev_out"])
        assert torch.equal(rcc[name]["prev_q"], rcp[name]["prev_q"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("what", ["decode", "prefill"])
def test_moe_step_functions_have_no_host_traffic(rng, arch, what):
    _, tcfg, _, tparams = reduced_model(arch)
    b = 2
    eng = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64)
    step = CompiledStep(tparams, tcfg,
                        tserve.init_serve_state(tcfg, b, 24, device="cpu"),
                        batch=b, engine=eng,
                        rcache=eng.init_cache(b, device="cpu"), graphs=False)
    prompts = rng.integers(0, tcfg.vocab, (b, 8)).astype(np.int32)
    step.prefill(prompts)
    step.decode(np.ones((b, 1), np.int32))
    with torch.no_grad(), NoHostTraffic():
        if what == "prefill":
            step.run_prefill(step.prompts[(b, 8)])
        else:
            step.tokens.fill_(3)
            step.run_decode()


def test_expert_reuse_step_has_no_host_traffic(rng):
    _, tcfg, _, tp = moe_block("mixtral-8x7b", top_k=1)
    cache = ter.layer_slice(ter.init_expert_reuse_cache(tcfg, 4,
                                                        device="cpu"), 0)
    x = torch.from_numpy(expert_reuse_stream(rng)[0])
    with torch.no_grad(), NoHostTraffic():
        ter.moe_reuse_forward(tp, tcfg, x, cache, block_k=32)


# ------------------------------------------ the serves, end to end

SERVE = ["--reduced", "--requests", "4", "--batch-slots", "2",
         "--prompt-len", "8", "--cache-len", "24", "--max-new", "6",
         "--reuse"]


class RecordingBatcher:
    """Wraps a batcher class so the requests its `run` returns are kept."""

    def __init__(self, cls):
        self.cls, self.done = cls, []

    def __call__(self, *a, **kw):
        b = self.cls(*a, **kw)
        run = b.run

        def recorded(*ra, **rkw):
            out = run(*ra, **rkw)
            self.done.extend(out)
            return out

        b.run = recorded
        return b


def _rows(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_serves(request, tmp_path_factory):
    """`serve --arch <moe> --reduced --reuse` in both packages (the
    reference's serve builds its engine at impl "jnp"), the port given the
    reference's weights, on its "jnp" tier and on its default one."""
    from repro.launch import serve as jserve_cli

    arch = request.param
    d = tmp_path_factory.mktemp(arch)
    mp = pytest.MonkeyPatch()
    rec = RecordingBatcher(jserve_cli.ContinuousBatcher)
    mp.setattr(jserve_cli, "ContinuousBatcher", rec)
    mp.setattr(sys, "argv", ["serve", "--arch", arch, *SERVE,
                             "--sensor-jsonl", str(d / "ref.jsonl")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve_cli.main()
    ref = {"text": buf.getvalue(), "rows": _rows(d / "ref.jsonl"),
           "tokens": {r.rid: list(r.output) for r in rec.done}}
    tree = jax.tree.map(np.asarray, jinit_params(
        JARCHS[arch].reduced(), jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, ARCHS[arch].reduced(), "cpu")
    mp.setattr(tserve_cli, "init_params", lambda cfg, seed, device: params)
    port = {}
    for impl in ("jnp", "auto"):
        out = d / f"{impl}.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tserve_cli.run(ARCHS[arch].reduced(),
                                 tserve_cli.build_parser().parse_args(
                                     ["--arch", arch, *SERVE, "--device",
                                      "cpu", "--impl", impl,
                                      "--sensor-jsonl", str(out)]))
        port[impl] = {"text": buf.getvalue(), "rows": _rows(out),
                      "tokens": {r.rid: list(r.output) for r in res["done"]},
                      "engine": res["engine"]}
    mp.undo()
    return arch, ref, port


def _report_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("SensorReport")]


def test_moe_serve_matches_reference(moe_serves):
    arch, ref, port = moe_serves
    sites = {"attn_qkv", "attn_out"}
    if arch.startswith("llama4"):
        sites |= {"moe_shared_in", "moe_shared_out"}
    for impl, got in port.items():
        assert set(got["engine"].sites) == sites
        assert got["tokens"] == ref["tokens"]
        assert _report_lines(got["text"]) == _report_lines(ref["text"])
        assert len(got["tokens"]) == 4
    # the reference's tier: every row equal; the kernel tier: every row
    # equal but its exec_path
    assert port["jnp"]["rows"] == ref["rows"]
    assert {r["exec_path"] for r in ref["rows"] if r["kind"] != "model"} \
        == {"dense"}
    assert_rows_match(ref["rows"], port["auto"]["rows"])


@pytest.fixture(scope="module")
def mixtral_measured():
    """`run_measured_decode("mixtral-8x7b")` at its operating point in both
    packages, the port given the reference's weights."""
    corr = dict(trunner.MEASURED_OPERATING_POINTS)["mixtral-8x7b"]
    kw = dict(steps=6, batch=2, correlation=corr)
    jm = jrunner.run_measured_decode("mixtral-8x7b", **kw)
    tree = jax.tree.map(np.asarray, jinit_params(
        JARCHS["mixtral-8x7b"].reduced(), jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, ARCHS["mixtral-8x7b"].reduced(), "cpu")
    ports = {impl: trunner.run_measured_decode(
        "mixtral-8x7b", device="cpu", params=params, impl=impl, **kw)
        for impl in ("jnp", None)}
    return jm, ports


def test_measured_decode_mixtral_matches_reference(mixtral_measured):
    jm, ports = mixtral_measured
    assert ports["jnp"].report.to_dicts() == jm.report.to_dicts()
    assert ports["jnp"].report.summary_lines() == jm.report.summary_lines()
    assert_rows_match(jm.report.to_dicts(), ports[None].report.to_dicts())
    for tm in ports.values():
        assert tm.skip_fractions == jm.skip_fractions
        assert_caches_match(jm.cache, tm.cache)
    # the correlated stream skips tiles at layer 0's attn_qkv
    l0 = next(r for r in ports["jnp"].report.per_layer
              if r.site == "attn_qkv" and r.layer == 0)
    assert l0.skipped_tiles > 0
