"""The port's `compact` exec path and the reference serve's `jnp` tier, and
the quantization helpers, against the JAX package's on the CPU.

`ops.reuse_matmul_compact` is the plain product over all of K (Δ is zero
outside the live K-blocks), where the reference gathers its budget's blocks
and falls back to the full extent when the live count overflows: the values
agree within atol 1e-5 + rtol 1e-5 at every budget.
Through the engines (the reference's at impl "jnp", the port's at "jnp"
and "cuda") every sensor counter is equal, the compact branch's
`dma_issued_tiles`, `grid_steps` and `overflow_fallbacks` among them, and
so are the exec paths the `jnp` tier resolves and promotes to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ReuseEngine as JEngine
from repro.core.policy import ReusePolicy as JPolicy
from repro.core.policy import SiteTunables as JTunables
from repro.core.reuse_cache import ReuseSiteSpec as JSpec
from repro.kernels import ops as jops
from repro.quant import quantize as jquant
from repro_torch.core.engine import ReuseEngine
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.core.reuse_cache import ReuseSiteSpec, default_exec_path
from repro_torch.kernels import ops
from repro_torch.quant import QuantSpec, calibrate_scale, fake_quantize
from repro_torch.serve import serve_step as tserve
from repro_torch.serve.compiled_step import CompiledStep
from test_torch_compiled_step import NoHostTraffic
from test_torch_engine import assert_caches_match, stream, t
from test_torch_serve import configs as qwen3_configs

ATOL = RTOL = 1e-5


# ------------------------------------------------- the compact gather GEMM

def compact_operands(rng, m, k, n, bk, live):
    """Δ that is nonzero only in the K-blocks `live`, W, prev_out and the
    shared k-block mask."""
    gk = -(-k // bk)
    delta = np.zeros((m, k), np.float32)
    for j in live:
        delta[:, j * bk:(j + 1) * bk] = rng.normal(size=(m, min(bk, k - j * bk)))
    w = rng.normal(size=(k, n)).astype(np.float32)
    prev = rng.normal(size=(m, n)).astype(np.float32)
    mask = np.zeros((gk,), np.int32)
    mask[list(live)] = 1
    return delta, w, prev, mask


@pytest.mark.parametrize("k", [512, 448])          # 448: padded to 512
@pytest.mark.parametrize("budget", [None, 1, 2, 3, 4, 8])
def test_compact_gemm_matches_reference_at_every_budget(rng, k, budget):
    """Live count 3 of gk 4: budgets below it (the reference's full-extent
    fallback), at it, above it and absent give the same values."""
    bk = 128
    delta, w, prev, mask = compact_operands(rng, 8, k, 96, bk, (0, 2, 3))
    want = jops.reuse_matmul_compact(
        jnp.asarray(delta), jnp.asarray(w), jnp.asarray(prev),
        jnp.asarray(mask), block_k=bk, max_blocks=budget)
    got = ops.reuse_matmul_compact(t(delta), t(w), t(prev), t(mask),
                                   block_k=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("live", [(), (1,), (0, 1, 2, 3)])
def test_compact_gemm_edge_counts(rng, live):
    """No live block passes prev_out through bitwise; every block live is
    the full product."""
    delta, w, prev, mask = compact_operands(rng, 4, 256, 64, 64, live)
    got = ops.reuse_matmul_compact(t(delta), t(w), t(prev), t(mask),
                                   block_k=64)
    want = jops.reuse_matmul_compact(
        jnp.asarray(delta), jnp.asarray(w), jnp.asarray(prev),
        jnp.asarray(mask), block_k=64, max_blocks=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if not live:
        assert torch.equal(got, t(prev))


def test_compact_gemm_rejects_a_wrong_mask(rng):
    delta, w, prev, mask = compact_operands(rng, 4, 256, 64, 64, (1,))
    with pytest.raises(ValueError, match="k mask"):
        ops.reuse_matmul_compact(t(delta), t(w), t(prev), t(mask[:3]),
                                 block_k=64)


# ------------------------------------------- the compact branch's accounting

M = 4
# name, in, out, tunables: compact at budgets below, at and above the live
# counts the stream gives, and an "auto" site (the jnp tier: dense)
SITES = [
    ("cmp_b1", 256, 384, {"exec_path": "compact", "max_active_k": 1}),
    ("cmp_b3", 512, 128, {"exec_path": "compact", "max_active_k": 3}),
    ("cmp_full", 256, 256, {"exec_path": "compact"}),
    ("auto", 256, 256, {}),
]


def build(timpl, n_layers):
    jt = {n: JTunables(**kw) for n, _, _, kw in SITES if kw}
    tt = {n: SiteTunables(**kw) for n, _, _, kw in SITES if kw}
    je = JEngine(impl="jnp", policy=JPolicy(site_tunables=jt))
    te = ReuseEngine(impl=timpl, policy=ReusePolicy(site_tunables=tt))
    for name, fi, fo, _ in SITES:
        for eng in (je, te):
            eng.register(name, fi, fo, n_layers=n_layers, block_m=8,
                         block_k=64)
    return je, te


@pytest.mark.parametrize("timpl", ["jnp", "cuda"])
@pytest.mark.parametrize("n_layers", [0, 2])
def test_compact_sites_match_reference_engine(rng, timpl, n_layers):
    je, te = build(timpl, n_layers)
    jc, tc = je.init_cache(M), te.init_cache(M, device="cpu")
    lanes = range(n_layers) if n_layers else [None]
    for name, fi, fo, _ in SITES:
        w = (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32)
        japply = jax.jit(lambda x, w, e, name=name: je.apply(name, x, w,
                                                             None, e))
        for lane in lanes:
            for x in stream(rng, 6, fi):
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
                                           rtol=RTOL, atol=ATOL)
    assert_caches_match(jc, tc)
    paths = {n: s.exec_path for n, s in te.sites.items()}
    assert paths == {n: s.exec_path for n, s in je.sites.items()}
    ovf = {n: int(tc[n]["sensor"]["overflow_fallbacks"].sum())
           for n, _, _, _ in SITES}
    # budget 1 overflows on the stream's changed steps, no budget never
    assert ovf["cmp_b1"] > 0 and ovf["cmp_full"] == 0
    assert int(tc["cmp_b1"]["sensor"]["grid_steps"].sum()) > 0


def test_a_budget_move_on_a_compact_site_reaches_the_accounting(rng):
    """The budget lane, written in place by `set_budget`, is what the
    compact accounting reads: the same step before and after a move counts
    an overflow only under the small budget, through one engine."""
    _, te = build("jnp", 0)
    tc = te.init_cache(M, device="cpu")
    lane = te.budget_lanes["cmp_b3"]
    w = t((rng.normal(size=(512, 128)) / np.sqrt(512)).astype(np.float32))
    xs = stream(rng, 3, 512)
    te.apply("cmp_b3", t(xs[0]), w, None, tc["cmp_b3"])
    assert te.set_budget("cmp_b3", 8)
    assert te.budget_lanes["cmp_b3"] is lane and int(lane) == 8
    before = int(tc["cmp_b3"]["sensor"]["overflow_fallbacks"])
    te.apply("cmp_b3", t(xs[1]), w, None, tc["cmp_b3"])
    assert int(tc["cmp_b3"]["sensor"]["overflow_fallbacks"]) == before
    assert te.set_budget("cmp_b3", 1) and int(lane) == 1
    te.apply("cmp_b3", t(xs[2]), w, None, tc["cmp_b3"])
    assert int(tc["cmp_b3"]["sensor"]["overflow_fallbacks"]) == before + 1


# ------------------------------------------------------------ the jnp tier

@pytest.mark.parametrize("impl", ["jnp", "cuda", "torch"])
def test_jnp_tier_resolves_auto_to_dense_and_promotes_to_compact(impl):
    from repro.core.reuse_cache import default_exec_path as jdefault

    jimpl = "jnp" if impl == "jnp" else "pallas"
    assert default_exec_path(impl) == jdefault(jimpl)
    jpol, tpol = JPolicy(), ReusePolicy()
    for fi, bk in ((256, 64), (64, 64)):        # gk 4 and gk 1
        jspec, tspec = (cls("s", fi, 128, block_k=bk)
                        for cls in (JSpec, ReuseSiteSpec))
        for skip in (0.0, 0.2, 0.25, 0.9):
            assert tpol.decide_exec_path(tspec, skip, impl=impl) == \
                jpol.decide_exec_path(jspec, skip, impl=jimpl)
    assert tpol.decide_exec_path(ReuseSiteSpec("s", 256, 128, block_k=64),
                                 0.9, impl=impl) == \
        ("compact" if impl == "jnp" else "ragged")


def test_jnp_engine_promotion_matches_reference(rng):
    """A jnp-tier engine's exec refresh after a repeating stream promotes
    the site to compact with the reference's budget, and the next steps run
    it with the reference's counters."""
    je, te = JEngine(impl="jnp"), ReuseEngine(impl="jnp")
    for eng in (je, te):
        eng.register("s", 256, 128, n_layers=0, block_m=8, block_k=64)
    jc, tc = je.init_cache(M), te.init_cache(M, device="cpu")
    w = (rng.normal(size=(256, 128)) / 16).astype(np.float32)
    xs = stream(rng, 8, 256)
    for i, x in enumerate(xs):
        jo, jc["s"], _ = je.apply("s", jnp.asarray(x), jnp.asarray(w), None,
                                  jc["s"])
        to, _, _ = te.apply("s", t(x), t(w), None, tc["s"])
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
        if i == 3:
            assert te.sites["s"].exec_path == "auto"
            jchanged = je.refresh_exec_paths(jc)
            assert te.refresh_exec_paths(tc) == jchanged == {
                "s": "exec:compact"}
            assert te.sites["s"] == ReuseSiteSpec(
                **dataclasses.asdict(je.sites["s"]))
    assert_caches_match(jc, tc)


def test_compiled_compact_step_has_no_host_traffic(rng):
    """A decode step with compact pinned at every site reads nothing back
    from the device."""
    _, tcfg, _, _ = qwen3_configs("default")
    tpol = ReusePolicy(site_tunables={
        s: SiteTunables(exec_path="compact", max_active_k=1)
        for s in ("attn_qkv", "attn_out", "mlp_in", "mlp_out")})
    from repro_torch.models import init_params

    params = init_params(tcfg, 0, device="cpu")
    eng = tserve.build_reuse_engine(tcfg, impl="jnp", block_k=64,
                                    policy=tpol)
    step = CompiledStep(params, tcfg,
                        tserve.init_serve_state(tcfg, 2, 24, device="cpu"),
                        batch=2, engine=eng,
                        rcache=eng.init_cache(2, device="cpu"), graphs=False)
    step.prefill(rng.integers(0, tcfg.vocab, (2, 8)).astype(np.int32))
    step.decode(np.ones((2, 1), np.int32))
    step.tokens.fill_(3)
    with torch.no_grad(), NoHostTraffic():
        step.run_decode()
    assert {s.exec_path for s in eng.sites.values()} == {"compact"}
    assert sum(int(e["sensor"]["overflow_fallbacks"].sum())
               for e in step.rcache.values()) > 0


# ------------------------------------------------- calibration, fake quant

QUANT_SPECS = {
    "per_tensor": ({}, {}),
    "per_channel": ({"per_channel": True}, {"per_channel": True}),
    "fixed": ({"fixed_scale": 0.05}, {"fixed_scale": 0.05}),
    "four_bits": ({"bits": 4}, {"bits": 4}),
}


@pytest.mark.parametrize("which", list(QUANT_SPECS))
@pytest.mark.parametrize("shape", [(16, 24), (2, 3, 8)])
def test_calibrate_and_fake_quantize_match_reference(rng, which, shape):
    tkw, jkw = QUANT_SPECS[which]
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x[0, 0] = 0.0
    tspec, jspec = QuantSpec(**tkw), jquant.QuantSpec(**jkw)
    assert tspec.qmax == jspec.qmax
    s_t = calibrate_scale(t(x), tspec)
    s_j = jquant.calibrate_scale(jnp.asarray(x), jspec)
    assert s_t.dtype == torch.float32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        fake_quantize(t(x), tspec).numpy(),
        np.asarray(jquant.fake_quantize(jnp.asarray(x), jspec)))


def test_calibrate_scale_of_zeros_is_the_floor():
    z = torch.zeros((4, 4))
    np.testing.assert_array_equal(
        calibrate_scale(z).numpy(),
        np.asarray(jquant.calibrate_scale(jnp.zeros((4, 4)))))
    assert float(calibrate_scale(z)) > 0.0
