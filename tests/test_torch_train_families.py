"""The port's training forward and its gradients against the JAX package, on
the CPU, for every family the reference trains: the loss of
`repro_torch.train.loss_fn` and every gradient leaf from `torch.autograd`
against `jax.value_and_grad` of `repro.train.loss_fn`, on the reference's
reduced f32 configs, from the reference's parameters and the same batch.

Tolerances: the loss within rtol 1e-5 (sums of the same f32 terms in another
order); each gradient leaf within 1e-4·max|g| + 1e-7 of the reference's, the
max over that leaf: a gradient is a sum over the batch's tokens of products
that cancel, so its rounding error scales with the leaf's largest entries,
not with each entry.

Also: the serve keeps refusing the encoder, the training forward writes no
decode state, and rematerialisation ("full" and "dots") changes no
gradient."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data.pipeline import SyntheticAudioSource as JAudio
from repro.data.pipeline import SyntheticLMSource as JLM
from repro.models import init_params as jinit_params
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch.configs import ARCHS
from repro_torch.models import params_from_numpy
from repro_torch.models.transformer import check_family
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import _with_leaves, loss_fn

FAMILIES = ["qwen3-32b", "rwkv6-7b", "mixtral-8x7b", "zamba2-2.7b",
            "gemma3-12b", "hubert-xlarge"]
BATCH, SEQ = 2, 16
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops on many threads spend their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def batch_of(cfg, seed=0):
    if cfg.frontend == "audio":
        return JAudio(d_model=cfg.d_model, seq_len=SEQ, global_batch=BATCH,
                      vocab=cfg.vocab, seed=seed).batch(0)
    return JLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=seed,
               correlation=0.5).batch(0)


def port_grads(params, cfg, batch):
    """(loss, {path: grad}) of the port's loss_fn by torch.autograd."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = _with_leaves(params, leaves)
    loss, _ = loss_fn(tree, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), flat(_with_leaves(params, grads))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The reference's loss and gradients on one family: (config name,
    numpy parameters, numpy batch, loss, {path: grad})."""
    arch = request.param
    jcfg = JARCHS[arch].reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    nb = batch_of(jcfg)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return arch, to_np(jp), nb, float(loss), flat(to_np(g))


def test_loss_and_every_gradient_leaf_match_the_reference(family):
    arch, np_params, nb, jloss, jgrads = family
    cfg = ARCHS[arch].reduced()
    params = params_from_numpy(np_params, cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss, grads = port_grads(params, cfg, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(jgrads)
    for path, want in jgrads.items():
        got = grads[path].numpy()
        assert got.shape == want.shape, path
        assert np.isfinite(got).all(), path
        tol = GRAD_REL * float(np.abs(want).max()) + GRAD_ATOL
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{arch} {path}: max err {err:.3e} > {tol:.3e}"
    if arch == "rwkv6-7b":
        # the recurrence's parameters reach the loss through WKV6Sequence
        assert float(grads["blocks/rwkv/tmix/bonus"].abs().max()) > 0
        assert float(grads["blocks/rwkv/tmix/decay_base"].abs().max()) > 0


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_gradient(policy):
    """Each superblock under torch.utils.checkpoint (the recomputation runs
    the same ops on the same inputs): every gradient bitwise equal to the
    run without rematerialisation."""
    base = ARCHS["rwkv6-7b"].reduced()
    jp = jax.tree.map(np.asarray, jinit_params(
        JARCHS["rwkv6-7b"].reduced(), jax.random.PRNGKey(1)))
    batch = {k: torch.from_numpy(v) for k, v in batch_of(base, 1).items()}
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        runs[remat] = port_grads(params_from_numpy(jp, cfg, "cpu"), cfg,
                                 batch)
    assert torch.equal(runs[False][0], runs[True][0])
    for path, g in runs[False][1].items():
        assert torch.equal(g, runs[True][1][path]), path


def test_training_admits_the_encoder_and_the_serve_does_not():
    cfg = ARCHS["hubert-xlarge"]
    check_family(cfg, training=True)
    with pytest.raises(NotImplementedError, match="audio frontend"):
        check_family(cfg)
    with pytest.raises(NotImplementedError):
        check_family(dataclasses.replace(cfg, causal=True), training=True)
