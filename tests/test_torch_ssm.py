"""The port's RWKV6 slice against the JAX package: the wkv6 step, the time
and channel mix, and the reuse decode serve of reduced rwkv6-7b end to end.

Everything runs in f32 on the CPU, where the port's wrappers take their plain
versions. Inputs come from numpy and reach both packages as the same arrays.
The bonus u, the token-shift mixes `maa_*` and the state are made random and
nonzero: the reference initialises u and `maa_*` to zeros, and a zero u would
hide a wrong bonus term.

Tolerances: the readout `out` is a dk-term f32 sum taken in another order
(rtol 1e-5, atol 1e-5). The new state `w·S + kv` is bitwise: the port rounds
the product and the sum apart, as the reference's eager oracle does, and
XLA's CPU backend contracts them into one FMA in the compiled kernel, which
`fma_f32` reproduces. Through the time mix the two roundings feed later
tokens and cancel in places, so there the state is held to rtol 1e-5 and
atol 1e-5 (states of order 1). End to end, logits agree within rtol/atol
1e-4 (tests/test_torch_serve.py), and greedy tokens, int8 codes and every
sensor counter are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.policy import ReusePolicy as JPolicy
from repro.core.policy import SiteTunables as JTunables
from repro.kernels.wkv6_decode import wkv6_decode as jwkv6_decode
from repro.kernels.wkv6_decode import wkv6_decode_ref as jwkv6_decode_ref
from repro.models import init_params as jinit_params
from repro.models import ssm as jssm
from repro.serve import serve_step as jserve
from repro_torch.configs import ARCHS
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.core.similarity import fma_f32
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6_decode import wkv6_decode, wkv6_decode_torch
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import init_decode_state, init_params, params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import check_family
from repro_torch.serve import serve_step as tserve
from test_torch_engine import assert_caches_match

OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
SITES = ("rwkv_wr", "rwkv_wk", "rwkv_wv", "rwkv_wg", "rwkv_wo",
         "rwkv_cmix_wk", "rwkv_cmix_wv", "rwkv_cmix_wr")


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def wkv_inputs(rng, b, h, dk):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    w = rng.uniform(0.05, 0.999, size=(b, h, dk)).astype(np.float32)
    return f(b, h, dk), f(b, h, dk), f(b, h, dk), w, f(h, dk), f(b, h, dk, dk)


@pytest.mark.parametrize("b,h,dk", [(2, 4, 32), (1, 3, 64), (3, 2, 16)])
def test_wkv6_decode_matches_pallas_and_ref(rng, b, h, dk):
    r, k, v, w, u, s = wkv_inputs(rng, b, h, dk)
    jo, js = jwkv6_decode(*map(jnp.asarray, (r, k, v, w, u, s)),
                          interpret=True)
    ro, rs = jwkv6_decode_ref(*map(jnp.asarray, (r, k, v, w, u, s)))
    to, ts = wkv6_decode_torch(*map(t, (r, k, v, w, u, s)))
    oo, os_ = tref.wkv6_decode_ref(*map(t, (r, k, v, w, u, s)))
    for want_o in (jo, ro):
        np.testing.assert_allclose(to.numpy(), np.asarray(want_o),
                                   rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    kv = t(k)[..., :, None] * t(v)[..., None, :]
    np.testing.assert_array_equal(
        fma_f32(t(w)[..., :, None], t(s), kv).numpy(), np.asarray(js))
    assert torch.equal(oo, to) and torch.equal(os_, ts)
    # the bonus term is live: u = 0 changes the readout
    zo, _ = wkv6_decode_torch(*map(t, (r, k, v, w, np.zeros_like(u), s)))
    assert not np.allclose(zo.numpy(), to.numpy())


def test_wkv6_wrappers_update_the_state_in_place(rng):
    r, k, v, w, u, s = wkv_inputs(rng, 2, 4, 32)
    want_o, want_s = wkv6_decode_torch(*map(t, (r, k, v, w, u, s)))
    lanes = torch.zeros((3, 2, 4, 32, 32))  # a stacked [L, ...] state
    for layer, impl in ((0, "cuda"), (2, "torch")):
        lanes[layer] = t(s)
        out = ops.wkv6_decode(*map(t, (r, k, v, w, u)), lanes[layer],
                              impl=impl)
        assert torch.equal(out, want_o) and torch.equal(lanes[layer], want_s)
    assert not lanes[1].any()
    state = t(s)
    out, same = wkv6_decode(*map(t, (r, k, v, w, u)), state)
    assert same is state and torch.equal(state, want_s)
    with pytest.raises(ValueError, match="impl"):
        ops.wkv6_decode(*map(t, (r, k, v, w, u, s)), impl="pallas")
    with pytest.raises(ValueError, match="device"):
        wkv6_decode(*(x.to("meta") for x in map(t, (r, k, v, w, u, s))))


def random_rwkv_tree(rng, tree):
    """The reference's rwkv6 block pytree with the zero-initialised maa_*
    and bonus leaves (and the norm scales) replaced by random values."""
    tree = jax.tree.map(np.asarray, tree)
    tm, cm = tree["tmix"], tree["cmix"]
    for d, key in ((tm, "maa_x"), (tm, "maa_wkvrg"), (tm, "bonus"),
                   (cm, "maa_k"), (cm, "maa_r")):
        d[key] = rng.normal(size=d[key].shape).astype(np.float32) * 0.5
    for p in (tree["norm1"], tree["norm2"], tm["ln_x"]):
        p["scale"] = rng.normal(size=p["scale"].shape).astype(np.float32) * 0.1
    return tree


def test_time_mix_and_channel_mix_match_jax_prefill_then_decode(rng):
    jcfg, tcfg = JARCHS["rwkv6-7b"].reduced(), ARCHS["rwkv6-7b"].reduced()
    b, s = 2, 6
    tree = random_rwkv_tree(rng, jssm.init_rwkv6(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(tree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jssm.init_rwkv6_state(jcfg, b)
    tst = tssm.init_rwkv6_state(tcfg, b, device="cpu")
    jt = jax.jit(lambda p, x, st: jssm.rwkv6_time_mix(p, jcfg, x, st))
    jc = jax.jit(lambda p, x, st: jssm.rwkv6_channel_mix(p, jcfg, x, st))
    for n in (s, 1, 1):  # prefill, then two decode steps
        x = rng.normal(size=(b, n, jcfg.d_model)).astype(np.float32)
        jo, jst["tmix"] = jt(jp, jnp.asarray(x), jst["tmix"])
        to, _ = tssm.rwkv6_time_mix(tp, tcfg, t(x), tst["tmix"])
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(tst["tmix"]["wkv"].numpy(),
                                   np.asarray(jst["tmix"]["wkv"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tst["tmix"]["shift"].numpy(), x[:, -1])
        jo, jst["cmix"] = jc(jp, jnp.asarray(x), jst["cmix"])
        to, _ = tssm.rwkv6_channel_mix(tp, tcfg, t(x), tst["cmix"])
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tst["cmix"]["shift"].numpy(), x[:, -1])
    assert float(np.abs(np.asarray(jst["tmix"]["wkv"])).max()) > 0.1


def test_rwkv6_init_and_family_check():
    tcfg = ARCHS["rwkv6-7b"].reduced()
    p = init_params(tcfg, 0, device="cpu")
    jp = jinit_params(JARCHS["rwkv6-7b"].reduced(), jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), p) == shapes
    dtypes = jax.tree.map(lambda a: str(a.dtype), jp)
    assert jax.tree.map(lambda a: str(a.dtype).removeprefix("torch."),
                        p) == dtypes
    tm = p["blocks"]["rwkv"]["tmix"]
    assert not tm["bonus"].any() and not tm["maa_wkvrg"].any()
    assert bool((tm["decay_base"] == -6.0).all())
    st = init_decode_state(tcfg, 2, 16, device="cpu")
    jst = jserve.init_serve_state(JARCHS["rwkv6-7b"].reduced(), 2, 16)
    assert jax.tree.map(lambda a: tuple(a.shape), st) == jax.tree.map(
        lambda a: tuple(a.shape), jst)
    with pytest.raises(NotImplementedError, match="rwkv6"):
        check_family(dataclasses.replace(tcfg, tie_embeddings=True))


def configs(variant):
    jcfg, tcfg = JARCHS["rwkv6-7b"].reduced(), ARCHS["rwkv6-7b"].reduced()
    jpol, tpol = JPolicy(), ReusePolicy()
    if variant == "ragged":
        # max_active_k=1 < gk: live rows overflow the budget
        jpol = JPolicy(site_tunables={
            s: JTunables(exec_path="ragged", max_active_k=1) for s in SITES})
        tpol = ReusePolicy(site_tunables={
            s: SiteTunables(exec_path="ragged", max_active_k=1) for s in SITES})
    return jcfg, tcfg, jpol, tpol


B, PROMPT, CACHE, STEPS = 2, 8, 32, 4


@pytest.mark.parametrize("variant", ["default", "ragged"])
def test_rwkv6_slice_matches_jax(rng, variant):
    jcfg, tcfg, jpol, tpol = configs(variant)
    assert tcfg == type(tcfg)(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    blocks = tree["blocks"]["rwkv"]
    tree["blocks"]["rwkv"] = random_rwkv_tree(rng, blocks)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tcfg, "cpu")

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
    assert list(teng.sites) == list(jeng.sites) == list(SITES)
    for name, spec in teng.sites.items():
        js = jeng.sites[name]
        assert (spec.in_features, spec.out_features, spec.dataflow,
                spec.exec_path) == (js.in_features, js.out_features,
                                    js.dataflow, js.exec_path)
        assert spec.dataflow == "output"
    jrc, trc = jeng.init_cache(B), teng.init_cache(B, device="cpu")
    jdecode = jax.jit(lambda p, t, s, rc: jserve.decode_step(
        p, jcfg, t, s, engine=jeng, reuse_cache=rc))
    # the prefill's greedy token again at every step: layer 0's input and
    # its token shift are then unchanged, and its sites skip their tiles
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
    np.testing.assert_allclose(tstate["blocks"]["tmix"]["wkv"].numpy(),
                               np.asarray(jstate["blocks"]["tmix"]["wkv"]),
                               rtol=1e-4, atol=1e-5)
    for part in ("tmix", "cmix"):
        np.testing.assert_allclose(
            tstate["blocks"][part]["shift"].numpy(),
            np.asarray(jstate["blocks"][part]["shift"]), rtol=1e-5, atol=1e-5)
    assert_caches_match(jrc, trc)
    skipped = sum(int(e["sensor"]["skipped_tiles"].sum()) for e in trc.values())
    assert skipped > 0
    if variant == "ragged":
        assert sum(int(e["sensor"]["overflow_fallbacks"].sum())
                   for e in trc.values()) > 0


def test_rwkv6_serve_cli_on_cpu(capsys):
    tserve_cli.main(["--arch", "rwkv6-7b", "--reduced", "--requests", "3",
                     "--batch-slots", "2", "--prompt-len", "4",
                     "--max-new", "3", "--reuse", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("SensorReport rid=") == 3
    assert "SensorReport model:" in out
    assert all(f"site {s}:" in out for s in SITES)
    assert "served 3/3 requests" in out
