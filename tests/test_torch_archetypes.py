"""The port's remaining decoder archetypes against the JAX package, on the
CPU: the zamba2 hybrid (Mamba2 blocks and the shared attention block),
gemma3 local:global, qwen2-72b (QKV bias, untied head), nemotron-4-15b
(squared-ReLU MLP) and qwen2-vl-7b (M-RoPE, the vision stub).

Reduced configs run in f32 with the reference's weights carried over by
`params_from_numpy`; inputs come from numpy and reach both packages as the
same arrays. Tolerances: the same f32 products and sums taken in another
order, atol 1e-5 + rtol 1e-5 for single layers and the Mamba2 block (h
and y); 1e-4 for logits and decode state after a whole prefill and four
decode steps (the roundings of 12 layers compound). Int8 codes, sim lanes
and every sensor counter are bitwise (`assert_caches_match`), prev_out
within its GEMM tolerance. One module-scoped fixture per reference run.
"""

import contextlib
import dataclasses
import io
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve import serve_step as jserve
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import init_decode_state, init_params, params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import check_family
from repro_torch.serve import serve_step as tserve
from repro_torch.serve.compiled_step import CompiledStep
from test_torch_compiled_step import NoHostTraffic
from test_torch_engine import assert_caches_match
from test_torch_moe import RecordingBatcher

ATOL = RTOL = 1e-5
STEP_TOL = 1e-4
ARCHETYPES = ("zamba2-2.7b", "gemma3-12b", "qwen2-72b", "nemotron-4-15b",
              "qwen2-vl-7b")


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def reduced_model(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(
        tree, tcfg, "cpu")


# ------------------------------------------------------------ the family

def test_check_family_takes_the_archetypes_and_refuses_the_encoder():
    for arch in ARCHETYPES:
        for cfg in (ARCHS[arch], ARCHS[arch].reduced()):
            check_family(cfg)
    assert set(ARCHS) == set(JARCHS)
    with pytest.raises(NotImplementedError, match="audio frontend"):
        check_family(ARCHS["hubert-xlarge"])
    # kv_head_pad_to is ported with sharded serving, kv_cache_quant with
    # checkpointing
    check_family(dataclasses.replace(ARCHS["gemma3-12b"], kv_head_pad_to=16))
    check_family(dataclasses.replace(ARCHS["gemma3-12b"],
                                     kv_cache_quant=True))


@pytest.mark.parametrize("arch", ARCHETYPES)
def test_params_and_state_match_the_reference_layout(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = init_params(tcfg, 0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: str(a.dtype).removeprefix("torch."),
                        tp) == jax.tree.map(lambda a: str(a.dtype), jp)
    for cache_len in (16, 80):
        jst = jserve.init_serve_state(jcfg, 2, cache_len)
        tst = init_decode_state(tcfg, 2, cache_len, device="cpu")
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jst) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
            tst)


# ------------------------------------------------------------ the layers

@pytest.mark.parametrize("how", ["one_shot", "step_by_step"])
def test_mamba2_forward_matches_reference(rng, how):
    """One Mamba2 block of reduced zamba2 from a random nonzero state, over
    8 tokens at once and one token a call: output, conv state and h."""
    jcfg, tcfg = JARCHS["zamba2-2.7b"].reduced(), ARCHS["zamba2-2.7b"].reduced()
    jp = jssm.init_mamba2(jcfg, jax.random.PRNGKey(1))
    # nonzero A_log, D, dt_bias and biases, so no term hides behind a zero
    jp = {**jp, **{k: jnp.asarray(rng.normal(size=jp[k].shape) * 0.5,
                                  jnp.float32)
                   for k in ("A_log", "D", "dt_bias", "conv_b")}}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    b, s = 2, 8
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    st0 = {k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in jssm.init_mamba2_state(jcfg, b).items()}
    want, jst = jssm.mamba2_forward(jp, jcfg, jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, st0))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st0.items()}
    if how == "one_shot":
        got, _ = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(x), tst)
    else:
        got = torch.cat([tssm.mamba2_forward(
            tp, tcfg, torch.from_numpy(x[:, i:i + 1]), tst)[0]
            for i in range(s)], dim=1)
    close(t2n(got), want)
    close(t2n(tst["h"]), jst["h"])
    close(t2n(tst["conv"]), jst["conv"])  # in_proj outputs: f32 sums


@pytest.mark.parametrize("arch", ["gemma3-12b", "nemotron-4-15b",
                                  "qwen2-72b"])
def test_mlp_forward_matches_reference(rng, arch):
    """gelu (the tanh approximation, jax.nn.gelu's default), relu2 and
    swiglu."""
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jlayers.init_mlp(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    close(t2n(tlayers.mlp_forward(tp, tcfg, torch.from_numpy(x))),
          jlayers.mlp_forward(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_and_apply_norm_match_reference(rng, dtype):
    """layer_norm (population variance), and apply_norm taking it for a
    norm with a bias, as the reference's."""
    x = (rng.normal(size=(3, 7, 96)) * 3 + 0.5).astype(np.float32)
    scale = rng.normal(size=96).astype(np.float32)
    bias = rng.normal(size=96).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == np.float32
                                else torch.bfloat16)
    want = jlayers.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-6)
    got = tlayers.layer_norm(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-6)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = ATOL if dtype == np.float32 else 2 ** -7
    close(t2n(got.float()), np.asarray(want, np.float32), atol=tol, rtol=tol)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    close(t2n(tlayers.apply_norm(p, tx, 1e-6).float()),
          np.asarray(jlayers.apply_norm(jp, jx, 1e-6), np.float32),
          atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2-72b", "nemotron-4-15b",
                                  "gemma3-12b"])
def test_init_helpers_match_reference_layout(arch):
    """init_norm, init_attention and init_mlp: the reference's keys, shapes
    and dtypes (stacked under `lead`), zero rms scales and QKV bias, the
    layer norm's unit scale and zero bias, and weights at 1/sqrt(fan_in)."""
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    gen = torch.Generator().manual_seed(0)
    for lead in ((), (3,)):
        for jp, tp in (
                (jlayers.init_attention(jcfg, jax.random.PRNGKey(1)),
                 tlayers.init_attention(tcfg, gen, lead=lead, device="cpu")),
                (jlayers.init_mlp(jcfg, jax.random.PRNGKey(2)),
                 tlayers.init_mlp(tcfg, gen, lead=lead, device="cpu")),
                (jlayers.init_mlp(jcfg, jax.random.PRNGKey(3), d_ff=64),
                 tlayers.init_mlp(tcfg, gen, 64, lead=lead, device="cpu"))):
            jl, tl = leaves(jp), leaves(tp)
            assert sorted(tl) == sorted(jl)
            for key, leaf in jl.items():
                got = tl[key]
                assert tuple(got.shape) == (*lead, *leaf.shape), key
                assert str(got.dtype).split(".")[-1] == str(leaf.dtype), key
                if key.endswith(("scale", "bqkv")):
                    np.testing.assert_array_equal(t2n(got)[(0,) * len(lead)],
                                                  np.asarray(leaf))
                else:
                    std = float(got.float().std()) * math.sqrt(leaf.shape[0])
                    assert 0.9 < std < 1.1, (key, std)
    for kind in ("rms", "layer"):
        want = jlayers.init_norm(24, kind)
        got = tlayers.init_norm(24, kind, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(t2n(got[key]), np.asarray(want[key]))


def test_apply_mrope_matches_reference(rng):
    """Three distinct position streams (temporal, height, width), at the
    sections of qwen2-vl's full and reduced head dims."""
    for cfg_name in ("full", "reduced"):
        tcfg = ARCHS["qwen2-vl-7b"]
        jcfg = JARCHS["qwen2-vl-7b"]
        if cfg_name == "reduced":
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        sections = tlayers._mrope_sections(tcfg)
        assert sections == jlayers._mrope_sections(jcfg)
        x = rng.normal(size=(2, 6, 3, tcfg.head_dim)).astype(np.float32)
        pos = rng.integers(0, 4096, size=(3, 2, 6)).astype(np.int32)
        close(t2n(tlayers.apply_mrope(torch.from_numpy(x),
                                      torch.from_numpy(pos), 1e6, sections)),
              jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  sections))


def test_embed_inputs_with_vision_embeds_matches_reference(rng):
    jcfg, tcfg, jparams, tparams = reduced_model("qwen2-vl-7b")
    tokens = rng.integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    ve = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    vp = np.array([[1, 4, 7], [0, 2, 9]], np.int32)
    want = jtransformer.embed_inputs(jparams, jcfg, {
        "tokens": jnp.asarray(tokens), "vision_embeds": jnp.asarray(ve),
        "vision_positions": jnp.asarray(vp)})
    got = ttransformer.embed_inputs(tparams, tcfg, {
        "tokens": torch.from_numpy(tokens), "vision_embeds":
        torch.from_numpy(ve), "vision_positions": torch.from_numpy(vp)})
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    np.testing.assert_array_equal(t2n(got)[0, 4], ve[0, 1])


# ------------------------------------------------------ the int8 KV cache

# (prompt, cache_len): mixtral's 66-token prompt overruns its 64-slot window
# cache, so the prefill writes the rolled tail and every decode step rolls
KV_QUANT_CASES = {"qwen3-32b": (8, 24), "mixtral-8x7b": (66, 64)}


@pytest.mark.parametrize("arch", sorted(KV_QUANT_CASES))
def test_kv_cache_quant_matches_reference(arch):
    """`kv_cache_quant`: a prefill and 4 decode steps (greedy tokens of the
    reference) in both packages. The K/V caches are int8 of the reference's
    shapes. After the prefill, which attends over the unquantized K/V, the
    codes are the port's own unquantized prefill K/V quantized
    (clip(round(t / 0.05))), and equal to the reference's codes wherever
    the two packages' unquantized K/V are bitwise equal, within one code
    elsewhere; after each decode step within one code. Logits within this
    file's step tolerance."""
    jcfg, tcfg, jparams, tparams = reduced_model(arch)
    jq = dataclasses.replace(jcfg, kv_cache_quant=True)
    tq = dataclasses.replace(tcfg, kv_cache_quant=True)
    prompt, cache = KV_QUANT_CASES[arch]
    b = 2
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab, (b, prompt)).astype(np.int32)
    runs = {}
    for name, jc, tc in (("plain", jcfg, tcfg), ("quant", jq, tq)):
        jst = jserve.init_serve_state(jc, b, cache)
        tst = init_decode_state(tc, b, cache, device="cpu")
        jlog, jst = jax.jit(lambda p, t, s, jc=jc: jserve.prefill_step(
            p, jc, t, s))(jparams, jnp.asarray(prompts), jst)
        tlog, tst = tserve.prefill_step(tparams, tc,
                                        torch.from_numpy(prompts), tst)
        runs[name] = (jlog, jst, tlog, tst)
    jlog, jst, tlog, tst = runs["quant"]
    assert tst["blocks"]["k"].dtype == torch.int8
    assert tuple(tst["blocks"]["k"].shape) == jst["blocks"]["k"].shape
    assert jst["blocks"]["k"].dtype == jnp.int8
    close(t2n(tlog), jlog, STEP_TOL, STEP_TOL)
    scale = tcfg.kv_quant_scale
    for kv in ("k", "v"):
        t_f = t2n(runs["plain"][3]["blocks"][kv])
        j_f = np.asarray(runs["plain"][1]["blocks"][kv])
        t_c = t2n(tst["blocks"][kv])
        j_c = np.asarray(jst["blocks"][kv])
        np.testing.assert_array_equal(
            t_c, np.clip(np.round(t_f / np.float32(scale)), -127, 127))
        same = t_f == j_f
        np.testing.assert_array_equal(t_c[same], j_c[same])
        assert np.abs(t_c.astype(int) - j_c.astype(int)).max() <= 1
    jdecode = jax.jit(lambda p, t, s: jserve.decode_step(p, jq, t, s))
    tok = np.array(jserve.greedy_sample(jlog))
    for _ in range(DECODE_STEPS):
        jlog, jst, _ = jdecode(jparams, jnp.asarray(tok), jst)
        tlog, tst, _ = tserve.decode_step(tparams, tq, torch.from_numpy(tok),
                                          tst)
        close(t2n(tlog), jlog, STEP_TOL, STEP_TOL)
        np.testing.assert_array_equal(t2n(tlog).argmax(-1),
                                      np.asarray(jlog).argmax(-1))
        for kv in ("k", "v"):
            diff = np.abs(t2n(tst["blocks"][kv]).astype(int)
                          - np.asarray(jst["blocks"][kv]).astype(int))
            assert diff.max() <= 1, kv
        tok = np.array(jserve.greedy_sample(jlog))
    assert int(tst["len"]) == prompt + DECODE_STEPS


# --------------------------------------- prefill, then decode with reuse

# (prompt, cache_len) of each arch: gemma3's 62-token prompt fills its local
# caches (window 64 in the reduced config) so decode steps 3 and 4 roll them
STEP_CASES = {"zamba2-2.7b": (8, 24), "gemma3-12b": (62, 80),
              "qwen2-72b": (8, 24), "nemotron-4-15b": (8, 24),
              "qwen2-vl-7b": (8, 24)}
DECODE_STEPS = 4


@pytest.fixture(scope="module", params=ARCHETYPES)
def decoded(request):
    """The reference's jitted prefill and 4 decode steps with reuse (its
    serve tier, impl "jnp"), and the port's on both of its tiers ("jnp" and
    its kernel tier, the plain versions on the CPU), on the same weights
    and tokens."""
    arch = request.param
    jcfg, tcfg, jparams, tparams = reduced_model(arch)
    prompt, cache = STEP_CASES[arch]
    b = 2
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab, (b, prompt)).astype(np.int32)
    jstate = jserve.init_serve_state(jcfg, b, cache)
    jlog, jstate = jax.jit(lambda p, t, s: jserve.prefill_step(p, jcfg, t, s))(
        jparams, jnp.asarray(prompts), jstate)
    jeng = jserve.build_reuse_engine(jcfg, impl="jnp", block_k=64)
    jrc = jeng.init_cache(b)
    jdecode = jax.jit(lambda p, t, s, rc: jserve.decode_step(
        p, jcfg, t, s, engine=jeng, reuse_cache=rc))
    jlogits, toks, jcodes = [np.asarray(jlog)], [], []
    tok = np.array(jserve.greedy_sample(jlog))
    for _ in range(DECODE_STEPS):
        toks.append(tok)
        jlog, jstate, jrc = jdecode(jparams, jnp.asarray(tok), jstate, jrc)
        jlogits.append(np.asarray(jlog))
        jcodes.append({n: np.asarray(e["prev_q"]) for n, e in jrc.items()})
        tok = np.array(jserve.greedy_sample(jlog))
    ports = {}
    for impl in ("jnp", "cuda"):
        state = tserve.init_serve_state(tcfg, b, cache, device="cpu")
        tlog, state = tserve.prefill_step(tparams, tcfg,
                                          torch.from_numpy(prompts), state)
        eng = tserve.build_reuse_engine(tcfg, impl=impl, block_k=64)
        rc = eng.init_cache(b, device="cpu")
        logits, flips = [t2n(tlog)], [[]]
        for tok, want in zip(toks, jcodes):
            tlog, state, rc = tserve.decode_step(
                tparams, tcfg, torch.from_numpy(tok), state, engine=eng,
                reuse_cache=rc)
            logits.append(t2n(tlog))
            # differing int8 codes per (layer, site), in call order
            flips.append([int((t2n(rc[n]["prev_q"][layer])
                               != want[n][layer]).sum())
                          for layer in range(tcfg.n_superblocks)
                          for n in eng.sites])
        ports[impl] = {"logits": logits, "flips": flips, "state": state,
                       "rc": rc, "engine": eng}
    return dict(arch=arch, jcfg=jcfg, jlogits=jlogits, jstate=jstate,
                jrc=jrc, jeng=jeng, ports=ports, prompt=prompt)


def test_prefill_and_decode_with_reuse_match_reference(decoded):
    """Logits of the prefill and each decode step, the whole decode state
    (KV caches, Mamba2 conv and h, the length) and the reuse cache, on both
    of the port's tiers.

    A site input that the two packages sum in another order can land on
    the other side of an int8 rounding boundary (scale 0.05): one code
    flips, shifts that site's outputs by 0.05·W[k, :] and flips codes at
    the sites after it, so that step's logits move by far more than the
    roundings. Such a step is excused from the logits check only where the
    first (layer, site) in call order whose codes differ has at most two
    differing codes (a rounding tie, not a wrong input); every other step's
    logits are held, and so is the state after the last step."""
    d = decoded
    assert set(d["ports"]["jnp"]["engine"].sites) == set(d["jeng"].sites)
    jst = leaves(d["jstate"])
    for port in d["ports"].values():
        held = 0
        for got, want, flips in zip(port["logits"], d["jlogits"],
                                    port["flips"]):
            if any(flips):
                assert next(n for n in flips if n) <= 2, flips
                continue
            close(got, want, STEP_TOL, STEP_TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            held += 1
        assert held >= DECODE_STEPS
        tst = leaves(port["state"])
        assert set(tst) == set(jst)
        for key, want in jst.items():
            close(t2n(tst[key]), want, STEP_TOL, STEP_TOL)
        assert int(tst["len"]) == d["prompt"] + DECODE_STEPS
        # a flipped code feeds the hit and skip counters of its site for
        # good: those sites are held by their codes (none may differ after
        # the last step) and prev_out; every other site bitwise
        sites = list(port["engine"].sites)
        flipped = {sites[i % len(sites)] for f in port["flips"]
                   for i, n in enumerate(f) if n}
        assert not any(port["flips"][-1])
        assert_caches_match({n: e for n, e in d["jrc"].items()
                             if n not in flipped}, port["rc"])
        for n in flipped:
            np.testing.assert_array_equal(t2n(port["rc"][n]["prev_q"]),
                                          np.asarray(d["jrc"][n]["prev_q"]))
            close(t2n(port["rc"][n]["prev_out"]), d["jrc"][n]["prev_out"],
                  STEP_TOL, STEP_TOL)
    if d["arch"] == "gemma3-12b":
        # the local caches rolled: 66 tokens in 64 slots
        local = d["ports"]["jnp"]["state"]["blocks"]["local"]["k"]
        assert local.shape[3] == d["jcfg"].window < d["prompt"] + DECODE_STEPS


# --------------------------------------------------- the compiled step

@pytest.mark.parametrize("arch", ARCHETYPES)
def test_compiled_step_is_bitwise_the_plain_steps_with_no_host_traffic(
        rng, arch):
    """CompiledStep (run directly) gives bitwise the plain steps' logits,
    state and reuse cache; its prefill and decode functions read no device
    value on the host and make no tensor from host data, so they capture."""
    _, tcfg, _, tparams = reduced_model(arch)
    b, (prompt, cache) = 2, STEP_CASES[arch]
    prompts = rng.integers(0, tcfg.vocab, (b, prompt)).astype(np.int32)
    runs = []
    for compiled in (True, False):
        eng = tserve.build_reuse_engine(tcfg, impl="cuda", block_k=64)
        rc = eng.init_cache(b, device="cpu")
        state = tserve.init_serve_state(tcfg, b, cache, device="cpu")
        tok = np.ones((b, 1), np.int32)
        if compiled:
            step = CompiledStep(tparams, tcfg, state, batch=b, engine=eng,
                                rcache=rc, graphs=False)
            logits = [step.prefill(prompts).clone()]
            for _ in range(3):
                logits.append(step.decode(tok).clone())
                tok = t2n(tserve.greedy_sample(logits[-1]))[:, :1]
            step.tokens.copy_(torch.from_numpy(tok))
            with torch.no_grad(), NoHostTraffic():
                step.run_decode()
                step.run_prefill(step.prompts[(b, prompt)])
        else:
            lg, state = tserve.prefill_step(tparams, tcfg,
                                            torch.from_numpy(prompts), state)
            logits = [lg]
            for _ in range(3):
                lg, state, rc = tserve.decode_step(
                    tparams, tcfg, torch.from_numpy(tok), state, engine=eng,
                    reuse_cache=rc)
                logits.append(lg)
                tok = t2n(tserve.greedy_sample(lg))[:, :1]
            # the compiled run's extra decode and prefill
            _, state, rc = tserve.decode_step(
                tparams, tcfg, torch.from_numpy(tok), state, engine=eng,
                reuse_cache=rc)
            _, state = tserve.prefill_step(tparams, tcfg,
                                           torch.from_numpy(prompts), state)
        runs.append((logits, leaves(state), leaves(rc)))
    (lc, sc, rcc), (lp, sp, rcp) = runs
    assert all(torch.equal(a, b) for a, b in zip(lc, lp))
    for key in sc:
        assert torch.equal(sc[key], sp[key]), key
    for key in rcc:
        if isinstance(rcc[key], torch.Tensor):
            assert torch.equal(rcc[key], rcp[key]), key


# ------------------------------------------------------ the serve CLI

SERVE = ["--reduced", "--requests", "4", "--batch-slots", "2",
         "--prompt-len", "8", "--cache-len", "24", "--max-new", "6",
         "--reuse"]


def _rows(path):
    return [json.loads(ln) for ln in open(path)]


def _report_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("SensorReport")]


@pytest.fixture(scope="module", params=["zamba2-2.7b", "gemma3-12b"])
def archetype_serves(request, tmp_path_factory):
    """`serve --arch <arch> --reduced --reuse` in both packages (the
    reference's serve builds its engine at impl "jnp"), the port given the
    reference's weights, on its "jnp" tier."""
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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tserve_cli.run(ARCHS[arch].reduced(),
                             tserve_cli.build_parser().parse_args(
                                 ["--arch", arch, *SERVE, "--device", "cpu",
                                  "--impl", "jnp", "--sensor-jsonl",
                                  str(d / "port.jsonl")]))
    mp.undo()
    port = {"text": buf.getvalue(), "rows": _rows(d / "port.jsonl"),
            "tokens": {r.rid: list(r.output) for r in res["done"]}}
    return arch, ref, port


def test_serve_matches_reference(archetype_serves):
    """Tokens, SensorReport lines and every sensor JSONL row."""
    arch, ref, port = archetype_serves
    assert len(port["tokens"]) == 4
    assert port["tokens"] == ref["tokens"]
    assert _report_lines(port["text"]) == _report_lines(ref["text"])
    assert port["rows"] == ref["rows"]
    attn, mlp = (("shared_attn", "shared_mlp") if arch == "zamba2-2.7b"
                 else ("attn_global", "mlp_global"))
    assert {r["site"] for r in port["rows"] if r["kind"] != "model"} == {
        f"{attn}_qkv", f"{attn}_out", f"{mlp}_in", f"{mlp}_out"}


@pytest.mark.parametrize("package", ["reference", "port"])
def test_serve_refuses_the_encoder(monkeypatch, package):
    """`serve --arch hubert-xlarge` refuses with the reference's message in
    both packages."""
    argv = ["--arch", "hubert-xlarge", "--reduced", "--requests", "1"]
    if package == "reference":
        from repro.launch import serve as jserve_cli

        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        with pytest.raises(AssertionError,
                           match="encoder archs have no decode path"):
            jserve_cli.main()
    else:
        with pytest.raises(ValueError,
                           match="encoder archs have no decode path"):
            tserve_cli.main([*argv, "--device", "cpu"])


# ---------------------------------------------- the K tail (qwen2-72b)

@pytest.mark.parametrize("path", ["output", "input", "ragged"])
def test_k_tail_site_hands_the_kernel_its_weight(rng, monkeypatch, path):
    """qwen2-72b's mlp_out has K = 29568 = 115.5 tiles of 256. At a small
    K-tail shape the padded entry pads Δ but hands the kernel wrapper the
    weight itself (same storage, its own rows: no pad, no copy), and the
    result is the reference's padded Pallas kernel's (interpret mode)."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import reuse_matmul as trm
    from repro_torch.kernels import reuse_matmul_ragged as trr

    m, k, n, bm, bk = 8, 1000, 256, 8, 256
    mask = np.array([[1, 0, 1, 1]], np.int32)
    delta = rng.normal(size=(m, k)).astype(np.float32)
    delta[:, bk:2 * bk] = 0  # zero wherever the mask skips
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    prev = rng.normal(size=(m, n)).astype(np.float32)
    want = jops.reuse_matmul(jnp.asarray(delta), jnp.asarray(w),
                             jnp.asarray(prev), jnp.asarray(mask), block_m=bm,
                             block_n=128, block_k=bk, interpret=True)
    mod, name = ((trr, "reuse_matmul_ragged") if path == "ragged"
                 else (trm, "reuse_matmul"))
    seen, orig = [], getattr(mod, name)

    def recording(d, ww, *a, **kw):
        seen.append(ww)
        return orig(d, ww, *a, **kw)

    monkeypatch.setattr(mod, name, recording)
    tw = torch.from_numpy(w)
    args = (torch.from_numpy(delta), tw, torch.from_numpy(prev),
            torch.from_numpy(mask))
    if path == "ragged":
        got = tops.reuse_matmul_ragged(*args, block_m=bm, block_n=128,
                                       block_k=bk)
    else:
        got = tops.reuse_matmul(*args, block_m=bm, block_n=128, block_k=bk,
                                dataflow=path)
    assert len(seen) == 1 and seen[0].data_ptr() == tw.data_ptr()
    assert tuple(seen[0].shape) == (k, n)
    close(t2n(got), want)
