"""The port's training path (`repro_torch.{optim,data,train}`,
`launch/{train,specs}`, `models.moe.router_aux_loss`, the rwkv6 recurrence's
gradient) against the JAX package, on the CPU, at the reduced f32 configs.

Tolerances: the optimizer, the schedule and the compression run the
reference's f32 arithmetic op for op (rtol 1e-6); batches are bitwise; the
chunked cross-entropy sums the same f32 terms in another order (rtol 1e-5);
three train steps are held at the reference's own microbatch tolerance
(`tests/test_train_optim.py`: rtol 2e-4, atol 2e-5), the resumed run at
`tests/test_system.py`'s (rtol 1e-5, atol 1e-6); the recurrence's gradient,
sums of the same products in another order, within rtol 1e-5 / atol 1e-6
(f32 sums of a few dozen terms of order 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.recovery import LoopConfig as JLoopConfig
from repro.ckpt.recovery import ResilientLoop as JLoop
from repro.configs import ARCHS as JARCHS
from repro.data.pipeline import SyntheticAudioSource as JAudio
from repro.data.pipeline import SyntheticLMSource as JLM
from repro.data.pipeline import make_source as jmake_source
from repro.launch import specs as jspecs
from repro.models import init_params as jinit_params
from repro.models.moe import router_aux_loss as jrouter_aux_loss
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro.train import train_step as jtrain
from repro_torch.ckpt.recovery import LoopConfig, ResilientLoop
from repro_torch.configs import ARCHS
from repro_torch.data import SyntheticAudioSource, SyntheticLMSource, make_source
from repro_torch.kernels import wkv6_decode as twkv
from repro_torch.kernels import ops as tops
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import params_from_numpy
from repro_torch.models.moe import router_aux_loss
from repro_torch.models.transformer import train_state_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedules as tsched
from repro_torch.train import train_step as ttrain

OPT_RTOL = 1e-6
XENT_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
WKV_RTOL, WKV_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops on many threads spend their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def assert_tree_close(got, want, rtol, atol):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for path in w:
        np.testing.assert_allclose(
            np.asarray(g[path].detach().float()), np.asarray(w[path],
                                                             np.float32),
            rtol=rtol, atol=atol, err_msg=path)


# ------------------------------------------------------------- optimizer

def grads_tree(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": f(16, 8) * 3.0, "blocks": {"scale": f(2, 8), "b": f(8)}}


def test_adamw_matches_reference_over_steps(rng):
    """Three updates from a state with nonzero moments; the global norm
    clips (max_norm 1.0 against a norm near 20), weight decay on ndim >= 2
    leaves only, a schedule factor below 1."""
    params = grads_tree(rng)
    cfg = tadamw.AdamWConfig(lr=1e-2)
    jstate = jadamw.init_opt_state(jax.tree.map(jnp.asarray, params))
    tparams = jax.tree.map(t, params)
    tstate = tadamw.init_opt_state(tparams)
    jparams = jax.tree.map(jnp.asarray, params)
    for i in range(3):
        g = grads_tree(rng)
        jparams, jstate, jm = jadamw.adamw_update(
            jadamw.AdamWConfig(lr=1e-2), jparams, jax.tree.map(jnp.asarray, g),
            jstate, lr_scale=jnp.float32(0.7))
        tparams, tstate, tm = tadamw.adamw_update(
            cfg, tparams, jax.tree.map(t, g), tstate,
            lr_scale=torch.tensor(0.7))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
    assert_tree_close(tparams, jparams, OPT_RTOL, 0)
    assert_tree_close(tstate["mu"], jstate["mu"], OPT_RTOL, 0)
    assert_tree_close(tstate["nu"], jstate["nu"], OPT_RTOL, 0)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32 and tstate["step"].ndim == 0


def test_weight_decay_only_on_matrices_and_stacked_scales():
    """The reference's rule is ndim >= 2: a stacked norm scale [L, d] takes
    weight decay, a vector does not."""
    params = {"w": torch.ones((4, 4)), "stacked": {"scale": torch.ones((2, 4))},
              "scale": torch.ones((4,))}
    grads = jax.tree.map(torch.zeros_like, params)
    state = tadamw.init_opt_state(params)
    cfg = tadamw.AdamWConfig(lr=1.0, weight_decay=0.1)
    new, _, _ = tadamw.adamw_update(cfg, params, grads, state)
    assert float((new["w"] - 0.9).abs().max()) < 1e-6
    assert float((new["stacked"]["scale"] - 0.9).abs().max()) < 1e-6
    assert torch.equal(new["scale"], torch.ones((4,)))


def test_clip_by_global_norm_matches_reference(rng):
    g = grads_tree(rng)
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = tadamw.clip_by_global_norm(jax.tree.map(t, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    assert_tree_close(tc, jc, OPT_RTOL, 0)


@pytest.mark.parametrize("step", [0, 1, 3, 10, 57, 100, 150])
def test_schedules_match_reference(step):
    j = jsched.linear_warmup_cosine(jnp.int32(step), warmup=10, total=100)
    got = tsched.linear_warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                      warmup=10, total=100)
    np.testing.assert_allclose(float(got), float(j), rtol=OPT_RTOL)
    assert tsched.constant(step, value=0.5) == jsched.constant(step, value=0.5)


def test_compression_with_feedback_matches_reference(rng):
    """Two rounds of error feedback: codes bitwise, scales, decompressed
    gradients and residuals at rtol 1e-6."""
    jres = tres = None
    for _ in range(2):
        g = grads_tree(rng)
        jc, jres = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                                jres)
        tc, tres = tcomp.compress_with_feedback(jax.tree.map(t, g), tres)
        for (jp, jl), (tp, tl) in zip(
                sorted(flat_leaves(jc).items()),
                sorted(flat_leaves(tc).items())):
            assert jp == tp
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_allclose(float(tl.scale), float(jl.scale),
                                       rtol=OPT_RTOL)
        assert_tree_close(tres, jres, OPT_RTOL, 1e-7)
        assert_tree_close(tcomp.decompress(tc), jcomp.decompress(jc),
                          OPT_RTOL, 0)


def flat_leaves(tree, prefix=""):
    """{path: CompressedLeaf} of a compressed tree (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("correlation,n_hosts,host_id",
                         [(0.0, 1, 0), (0.9, 1, 0), (0.7, 2, 1)])
def test_lm_batches_bitwise_the_reference(correlation, n_hosts, host_id):
    kw = dict(vocab=1000, seq_len=32, global_batch=8, seed=3,
              correlation=correlation, n_hosts=n_hosts, host_id=host_id)
    for step in (0, 5, 123):
        got, want = SyntheticLMSource(**kw).batch(step), JLM(**kw).batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_audio_batches_and_make_source_match_the_reference():
    kw = dict(d_model=64, seq_len=16, global_batch=4, vocab=504, seed=2)
    got, want = SyntheticAudioSource(**kw).batch(7), JAudio(**kw).batch(7)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for arch in ("qwen3-32b", "hubert-xlarge"):
        cell = tspecs.ShapeCell("c", "train", 16, 4)
        src = make_source(ARCHS[arch].reduced(), cell, seed=1,
                          correlation=0.5)
        ref = jmake_source(JARCHS[arch].reduced(), jspecs.ShapeCell(
            "c", "train", 16, 4), seed=1, correlation=0.5)
        assert type(src).__name__ == type(ref).__name__
        for k, v in ref.batch(3).items():
            np.testing.assert_array_equal(src.batch(3)[k], v)


# ----------------------------------------------------------------- specs

def test_specs_match_the_reference():
    assert {n: dataclasses.astuple(c) for n, c in tspecs.SHAPES.items()} == {
        n: dataclasses.astuple(c) for n, c in jspecs.SHAPES.items()}
    assert tspecs.FULL_ATTN_ARCHS == jspecs.FULL_ATTN_ARCHS
    assert tspecs.ENCODER_ARCHS == jspecs.ENCODER_ARCHS
    for arch in ARCHS:
        for shape, cell in tspecs.SHAPES.items():
            assert tspecs.cell_runnable(arch, shape) == \
                jspecs.cell_runnable(arch, shape)
            got = tspecs.input_specs(ARCHS[arch], cell)
            want = jspecs.input_specs(JARCHS[arch], jspecs.SHAPES[shape])
            assert sorted(got) == sorted(want)
            for k, s in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(s.shape)
                assert str(got[k].dtype).removeprefix("torch.") == str(
                    np.dtype(s.dtype)), (arch, shape, k)
    cfg = ARCHS["hubert-xlarge"].reduced()
    cell = tspecs.ShapeCell("c", "train", 8, 2)
    inputs = tspecs.make_dummy_inputs(cfg, cell, device="cpu")
    assert inputs["embeds"].dtype == torch.bfloat16
    assert inputs["embeds"].shape == (2, 8, cfg.d_model)
    assert bool((inputs["labels"] == 3).all())
    struct = tspecs.state_specs_struct({"a": {"b": torch.zeros(3, 2)}})
    assert struct["a"]["b"].device.type == "meta"


# ------------------------------------------------------------------ loss

def test_chunked_xent_matches_reference(rng):
    jcfg = JARCHS["qwen3-32b"].reduced()
    cfg = ARCHS["qwen3-32b"].reduced()
    np_params = jax.tree.map(np.asarray, jinit_params(jcfg,
                                                      jax.random.PRNGKey(0)))
    b, s = 2, 64
    h = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, -5:] = -1
    want = jtrain.chunked_xent_loss(jax.tree.map(jnp.asarray, np_params),
                                    jcfg, jnp.asarray(h), jnp.asarray(labels))
    got = ttrain.chunked_xent_loss(params_from_numpy(np_params, cfg, "cpu"),
                                   cfg, t(h), t(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=XENT_RTOL)
    # and its gradient through the checkpointed chunks: h's
    jg = jax.grad(lambda hh: jtrain.chunked_xent_loss(
        jax.tree.map(jnp.asarray, np_params), jcfg, hh,
        jnp.asarray(labels)))(jnp.asarray(h))
    th = t(h).requires_grad_(True)
    ttrain.chunked_xent_loss(params_from_numpy(np_params, cfg, "cpu"), cfg,
                             th, t(labels)).backward()
    tol = 1e-4 * float(np.abs(np.asarray(jg)).max()) + 1e-7
    assert float(np.abs(th.grad.numpy() - np.asarray(jg)).max()) <= tol


def test_router_aux_loss_matches_reference(rng):
    jcfg = JARCHS["mixtral-8x7b"].reduced()
    cfg = ARCHS["mixtral-8x7b"].reduced()
    np_params = jax.tree.map(np.asarray, jinit_params(jcfg,
                                                      jax.random.PRNGKey(2)))
    layer0 = jax.tree.map(lambda a: a[0], np_params["blocks"]["moe"])
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want = jrouter_aux_loss(jax.tree.map(jnp.asarray, layer0), jcfg,
                            jnp.asarray(x))
    p = params_from_numpy(layer0, cfg, "cpu")
    got = router_aux_loss(p, cfg, t(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the reference's loss_fn does not add it: neither does the port's
    assert "router_aux_loss" not in ttrain.loss_fn.__code__.co_names


# ------------------------------------------------------------ train steps

@pytest.fixture(scope="module")
def reference_steps():
    """The reference's three steps on reduced qwen3-32b from one init: plain
    (batch 2), microbatch=2 (batch 4) and compress_grads (batch 2)."""
    jcfg = JARCHS["qwen3-32b"].reduced()
    init = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0))
    out = {}
    for name, kw, gb in (("plain", {}, 2), ("microbatch", {"microbatch": 2}, 4),
                         ("compress", {"compress_grads": True}, 2)):
        src = JLM(vocab=jcfg.vocab, seq_len=32, global_batch=gb,
                  correlation=0.8)
        step = jax.jit(jtrain.make_train_step(
            jcfg, jadamw.AdamWConfig(lr=1e-3), total_steps=20,
            warmup_steps=1, **kw))
        state = dict(init)
        if name == "compress":
            state["residual"] = jax.tree.map(jnp.zeros_like, init["params"])
        losses, residuals = [], []
        for i in range(3):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in src.batch(i).items()})
            losses.append(float(m["loss"]))
            residuals.append(jax.tree.map(np.asarray, state.get("residual")))
        out[name] = (kw, gb, jax.tree.map(np.asarray, state), losses,
                     residuals)
    return jax.tree.map(np.asarray, init), out


# with compress_grads: an element whose corrected gradient lies within the
# packages' f32 differences of an int8 rounding boundary takes the other
# code in one package, so its decompressed gradient moves by one step of
# the leaf's scale and its residual by the same. Such an element is excused
# from the parameter tolerance, and then its parameter is held within 3
# steps of lr·1 (Adam's normalised update). The packages' gradients differ
# by a few 1e-6 of a leaf's largest entry (f32 sums over the batch in
# another order), which is a few 1e-4 of the code step (max/127), so about
# that share of the elements flips a step: at most 5e-3 of a leaf in 3 steps.
FLIP_SHARE = 5e-3


def code_flips(residual, want_residual):
    """{path: bool mask} of the elements whose residual differs from the
    reference's by more than a quarter of the leaf's code step (the
    residual of a kept code is within half a step of zero)."""
    got, want = flat(residual), flat(want_residual)
    out = {}
    for path, w in want.items():
        step = max(float(np.abs(w).max()) * 2.0, 1e-30)
        out[path] = np.abs(got[path].numpy() - w) > step / 4
    return out


@pytest.mark.parametrize("name", ["plain", "microbatch", "compress"])
def test_three_train_steps_match_reference(reference_steps, name):
    np_init, runs = reference_steps
    kw, gb, want, want_losses, want_residuals = runs[name]
    cfg = ARCHS["qwen3-32b"].reduced()
    tree = dict(np_init)
    if name == "compress":
        tree["residual"] = jax.tree.map(np.zeros_like, np_init["params"])
    state = train_state_from_numpy(tree, cfg, "cpu")
    step = ttrain.make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3),
                                  total_steps=20, warmup_steps=1, **kw)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=32, global_batch=gb,
                            correlation=0.8)
    losses, flipped = [], {}
    for i in range(3):
        state, m = step(state, {k: t(v) for k, v in src.batch(i).items()})
        losses.append(float(m["loss"]))
        if name == "compress":
            for path, mask in code_flips(state["residual"],
                                         want_residuals[i]).items():
                flipped[path] = flipped.get(path, False) | mask
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_RTOL)
    assert int(state["opt"]["step"]) == 3
    got_p, want_p = flat(state["params"]), flat(want["params"])
    got_mu, want_mu = flat(state["opt"]["mu"]), flat(want["opt"]["mu"])
    assert sorted(got_p) == sorted(want_p)
    for path in want_p:
        keep = ~flipped.get(path, np.zeros(want_p[path].shape, bool))
        assert keep.mean() >= 1 - FLIP_SHARE, path
        for got, exp in ((got_p, want_p), (got_mu, want_mu)):
            np.testing.assert_allclose(got[path].numpy()[keep],
                                       exp[path][keep], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=path)
        assert np.abs(got_p[path].numpy() - want_p[path]).max() <= 3e-3


# ------------------------------------------------------------------ resume

def test_port_resumes_the_reference_checkpoint(tmp_path):
    """tests/test_system.py across the packages: the reference trains steps
    0..7 under its ResilientLoop (checkpoints at 0 and 7) and "dies"; the
    port's ResilientLoop resumes at 8 from that checkpoint and runs to 12;
    its parameters match the reference's straight 12 steps."""
    jcfg = JARCHS["qwen3-32b"].reduced()
    cfg = ARCHS["qwen3-32b"].reduced()
    jsrc = JLM(vocab=jcfg.vocab, seq_len=32, global_batch=2, correlation=0.8)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3),
                                           total_steps=20, warmup_steps=1))
    jbatch = lambda i: {k: jnp.asarray(v)  # noqa: E731
                        for k, v in jsrc.batch(i).items()}
    init = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0))
    state_a = init
    for i in range(12):
        state_a, _ = jstep(state_a, jbatch(i))
    JLoop(jstep, jbatch, JLoopConfig(ckpt_dir=str(tmp_path),
                                     ckpt_every=7)).run(init, 0, 8)

    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=32, global_batch=2,
                            correlation=0.8)
    step = ttrain.make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3),
                                  total_steps=20, warmup_steps=1)
    loop = ResilientLoop(step, lambda i: {k: t(v) for k, v in
                                          src.batch(i).items()},
                         LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=100))
    np_init = jax.tree.map(np.asarray, init)
    state_c, start = loop.resume_or_init(
        lambda: train_state_from_numpy(np_init, cfg, "cpu"))
    assert start == 8 and int(state_c["opt"]["step"]) == 8
    state_c = loop.run(state_c, start, 12 - start)
    assert_tree_close(state_c["params"],
                      jax.tree.map(np.asarray, state_a["params"]),
                      RESUME_RTOL, RESUME_ATOL)


def test_train_cli_trains_resumes_and_refuses_without_a_card(tmp_path,
                                                             capsys):
    """`launch.train` on the CPU: the reference's log lines, a falling loss
    on a correlated stream cut, checkpoints in the reference's layout, a
    resume from them; without `--device cpu` it needs a card."""
    def argv(steps, *extra):
        return ["--arch", "qwen3-32b", "--reduced", "--steps", str(steps),
                "--batch", "2", "--seq", "32", "--lr", "2e-3",
                "--correlation", "0.9", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "3", "--log-every", "1", *extra]

    cfg = ARCHS["qwen3-32b"].reduced()
    parse = ttrain_cli.build_parser().parse_args
    res = ttrain_cli.run(cfg, parse(argv(6, "--device", "cpu")))
    out = capsys.readouterr().out
    assert "step     5  loss" in out and "done: 6 steps" in out
    assert res["start"] == 0 and len(res["losses"]) == 6
    assert sorted(p.name for p in tmp_path.glob("*.COMPLETE")) == [
        "step_000000.COMPLETE", "step_000003.COMPLETE"]
    res2 = ttrain_cli.run(cfg, parse(argv(6, "--device", "cpu", "--resume")))
    assert res2["start"] == 4 and int(res2["state"]["opt"]["step"]) == 10
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain_cli.main(argv(2))


# ------------------------------------------------------- the wkv gradient

def wkv_inputs(rng, b, s, h, dk):
    f = lambda *sh: t(rng.normal(size=sh).astype(np.float32))  # noqa: E731
    w = t(rng.uniform(0.05, 0.999, size=(b, s, h, dk)).astype(np.float32))
    return (f(b, s, h, dk), f(b, s, h, dk), f(b, s, h, dk), w, f(h, dk),
            f(b, h, dk, dk))


def plain_sequence(r, k, v, w, u, s0):
    """The recurrence as plain differentiable steps (nothing in place)."""
    state, outs = s0, []
    for i in range(r.shape[1]):
        o, state = twkv.wkv6_decode_torch(r[:, i], k[:, i], v[:, i], w[:, i],
                                          u, state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


def test_wkv6_step_backward_matches_autograd(rng):
    """One step's plain backward against autograd of the plain step; the
    CPU wrapper writes S̄ into ∂L/∂S' in place and returns ū per batch row."""
    r, k, v, w, u, s = wkv_inputs(rng, 2, 1, 4, 8)
    r, k, v, w = (a[:, 0].contiguous() for a in (r, k, v, w))
    go = t(rng.normal(size=(2, 4, 8)).astype(np.float32))
    gs = t(rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
    ins = [a.clone().requires_grad_(True) for a in (r, k, v, w, u, s)]
    o, s_new = twkv.wkv6_decode_torch(*ins)
    want = torch.autograd.grad((o * go).sum() + (s_new * gs).sum(), ins)
    g_state = gs.clone()
    g_r, g_k, g_v, g_w, g_u = twkv.wkv6_decode_backward(r, k, v, w, u, s, go,
                                                        g_state)
    for got, exp, name in zip((g_r, g_k, g_v, g_w, g_u.sum(0), g_state),
                              want, ("r", "k", "v", "w", "u", "S")):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=WKV_RTOL,
                                   atol=WKV_ATOL, err_msg=name)


def test_wkv6_sequence_matches_the_plain_recurrence(rng):
    """WKV6Sequence on the CPU (the plain step forward, the plain backward
    step by step): outputs bitwise the plain recurrence's and the serve's
    in-place loop's, gradients of every input (r, k, v, w, u and the
    initial state) against autograd through the plain recurrence."""
    ins = wkv_inputs(rng, 2, 5, 3, 8)
    g_out = t(rng.normal(size=(2, 5, 3, 8)).astype(np.float32))
    g_last = t(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    out_a, last_a = twkv.WKV6Sequence.apply(*a)
    out_b, last_b = plain_sequence(*b)
    assert torch.equal(out_a, out_b) and torch.equal(last_a, last_b)
    state = ins[5].clone()
    served = torch.stack([tops.wkv6_decode(*(x[:, i] for x in ins[:4]),
                                           ins[4], state, impl="cuda")
                          for i in range(5)], dim=1)
    assert torch.equal(served, out_a.detach()) and torch.equal(state, last_a)
    ga = torch.autograd.grad((out_a * g_out).sum() + (last_a * g_last).sum(), a)
    gb = torch.autograd.grad((out_b * g_out).sum() + (last_b * g_last).sum(), b)
    for x, y, name in zip(ga, gb, ("r", "k", "v", "w", "u", "s0")):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=WKV_RTOL,
                                   atol=WKV_ATOL, err_msg=name)


def test_bf16_product_gradient_split_against_f32(monkeypatch):
    """The card's f32_product gradient (`_BF16ProductF32`: the f32
    cotangent as a bf16 hi/lo pair, bf16 products with f32 outputs),
    rehearsed on the CPU with the bf16 product done in f32 (exact: products
    of bf16 values are exact in f32): against autograd of the f32 product
    of the same values, within 2^-15 of each gradient's largest entry plus
    the bf16 rounding of the result (2^-8 relative)."""
    monkeypatch.setattr(tops, "_mm_f32", lambda a, b: a.float() @ b.float())
    g = torch.Generator().manual_seed(0)
    for shape_a, shape_b in (((6, 32), (32, 5)), ((3, 4, 16), (3, 16, 7))):
        a = torch.randn(shape_a, generator=g).to(torch.bfloat16)
        b = torch.randn(shape_b, generator=g).to(torch.bfloat16)
        cot = torch.randn(shape_a[:-1] + shape_b[-1:], generator=g)
        a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = tops._BF16ProductF32.apply(a1, b1)
        assert out.dtype == torch.float32
        ga, gb = torch.autograd.grad((out * cot).sum(), (a1, b1))
        assert ga.dtype == gb.dtype == torch.bfloat16
        a2, b2 = (x.float().requires_grad_(True) for x in (a, b))
        wa, wb = torch.autograd.grad(((a2 @ b2) * cot).sum(), (a2, b2))
        for got, want in ((ga, wa), (gb, wb)):
            tol = 2.0 ** -15 * float(want.abs().max()) + 2.0 ** -8 * \
                want.abs()
            assert bool(((got.float() - want).abs() <= tol).all())
