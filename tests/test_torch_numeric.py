"""Parity of the PyTorch port's numeric leaves with the JAX package.

Inputs are made with numpy from a seed and handed to both sides; codes,
masks, indices and counts must be bitwise equal, float outputs of the same
elementwise chain too."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import similarity as jsim
from repro.quant import quantize as jquant
from repro_torch.core import delta as tdelta
from repro_torch.core import similarity as tsim
from repro_torch.quant import quantize as tquant


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def f32(a):
    """numpy f32 view of a jax or torch array (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def activations(rng, m, k, scale):
    """Normal activations with a quarter of the entries exactly half-way
    between two codes, so round-half-to-even is exercised."""
    x = rng.normal(size=(m, k)).astype(np.float32) * 2.0
    half = (rng.integers(-100, 100, size=(m, k)) + 0.5) * scale
    return np.where(rng.random((m, k)) < 0.25, half, x).astype(np.float32)


@pytest.mark.parametrize("scale", [0.05, 0.0625, 0.013])
def test_quantize_int8_bitwise(rng, scale):
    x = activations(rng, 16, 300, scale)
    s = np.float32(scale)
    jq = np.asarray(jquant.quantize_int8(jnp.asarray(x), jnp.float32(s)))
    tq = tquant.quantize_int8(t(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(tq, jq)
    jd = np.asarray(jquant.dequantize_int8(jnp.asarray(jq), jnp.float32(s)))
    td = tquant.dequantize_int8(t(jq), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("m,k,bm,bk", [(16, 256, 8, 128), (12, 300, 8, 128),
                                       (5, 70, 8, 64)])
def test_similarity_and_block_mask_bitwise(rng, m, k, bm, bk):
    cur = rng.integers(-3, 4, size=(m, k)).astype(np.int8)
    prev = cur.copy()
    prev[rng.random((m, k)) < 0.01] += 1
    prev[:, : min(k, bk)] = cur[:, : min(k, bk)]  # one fully unchanged column
    np.testing.assert_array_equal(
        tsim.row_code_similarity(t(cur), t(prev)).numpy(),
        np.asarray(jsim.row_code_similarity(jnp.asarray(cur), jnp.asarray(prev))))
    dq = cur.astype(np.int32) - prev.astype(np.int32)
    np.testing.assert_array_equal(
        tsim.block_zero_mask(t(dq), bm, bk).numpy(),
        np.asarray(jsim.block_zero_mask(jnp.asarray(dq), bm, bk)))


def test_ema_update_bitwise(rng):
    """The EMA of a row similarity, bitwise equal to the reference's
    `ema_update(stat, row_code_similarity(...))` inside a compiled step."""
    step = jax.jit(lambda s, c, p: jsim.ema_update(
        s, jsim.row_code_similarity(c, p), 0.9))
    for k in (64, 640, 5120):
        stat = rng.random(8).astype(np.float32)
        cur = rng.integers(-2, 3, size=(8, k)).astype(np.int8)
        prev = rng.integers(-2, 3, size=(8, k)).astype(np.int8)
        want = step(jnp.asarray(stat), jnp.asarray(cur), jnp.asarray(prev))
        got = tsim.ema_update_mean(
            t(stat), tsim.row_code_matches(t(cur), t(prev)), k, 0.9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k", [(16, 256), (12, 300), (1, 619), (17, 446)])
def test_similarity_measures_bitwise(rng, m, k):
    """The paper's Fig. 3/4 measures on int8 codes, bitwise: the f32 means
    are XLA's count times f32(1/n), so a wholly unchanged input is
    harvestable at 1 - n·f32(1/n), as in the reference."""
    cur = rng.integers(-3, 4, size=(m, k)).astype(np.int8)
    for p in (0.0, 0.01, 0.3, 1.0):
        prev = cur.copy()
        prev[rng.random((m, k)) < p] += 1
        jc, jp = jnp.asarray(cur), jnp.asarray(prev)
        tc, tp = t(cur), t(prev)
        np.testing.assert_array_equal(tsim.code_similarity(tc, tp).numpy(),
                                      np.asarray(jsim.code_similarity(jc, jp)))
        want = jsim.similarity_breakdown(jc, jp)
        got = tsim.similarity_breakdown(tc, tp)
        assert sorted(got) == sorted(want)
        for key in want:
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        for bm, bk in ((8, 128), (1, 64), (4, 32)):
            g = tsim.harvestable_similarity(tc, tp, bm, bk).numpy()
            w = np.asarray(jsim.harvestable_similarity(jc, jp, bm, bk))
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_ema_update_as_written_bitwise(rng):
    for decay in (0.9, 0.95, 0.7):
        stat = rng.random(8).astype(np.float32)
        obs = rng.random(8).astype(np.float32)
        np.testing.assert_array_equal(
            tsim.ema_update(t(stat), t(obs), decay).numpy(),
            np.asarray(jsim.ema_update(jnp.asarray(stat), jnp.asarray(obs),
                                       decay)))


def test_core_exports_the_reference_names():
    import repro.core as jcore
    import repro_torch.core as tcore

    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        obj = getattr(tcore, name)
        assert getattr(obj, "__name__", name) == name or not callable(obj)
    assert tcore.code_similarity is tsim.code_similarity
    assert callable(tcore.reuse_linear)
    # a kernel module imported first (it imports the core's leaves, and
    # the core's engine imports the kernels) must not meet a half-built one
    import subprocess
    import sys

    subprocess.run([sys.executable, "-c", "import repro_torch.kernels.ref"],
                   check=True)


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest to the exact rational x, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.int32)) & 1))


def test_fma_f32_rounds_once(rng):
    """One rounding of the exact a·b + c, including a case where rounding
    the f64 sum and then to f32 (two roundings) gives the other neighbour."""
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    b = float(np.float32(1 - 2.0 ** -23))
    c = np.float32(1 + 2.0 ** -23)
    got = tsim.fma_f32(t(np.array([a])), b, t(np.array([c])))
    assert got.item() == c  # the exact sum lies just below the midpoint
    assert np.float32(float(a) * b + float(c)) != c  # two roundings miss
    av = rng.normal(size=64).astype(np.float32)
    cv = rng.normal(size=64).astype(np.float32) * 1e3
    got = tsim.fma_f32(t(av), 0.1, t(cv)).numpy()
    bf = Fraction(float(np.float32(0.1)))
    want = [_round_f32(Fraction(float(x)) * bf + Fraction(float(y)))
            for x, y in zip(av, cv)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,bm,bk", [(16, 512, 8, 128), (10, 200, 8, 64)])
def test_delta_encode_bitwise(rng, dtype, m, k, bm, bk):
    scale = np.float32(0.05)
    x = activations(rng, m, k, float(scale))
    prev = np.asarray(jquant.quantize_int8(jnp.asarray(x), jnp.float32(scale)))
    prev = prev.copy()
    prev[: m // 2] = rng.integers(-127, 128, size=(m // 2, k)).astype(np.int8)
    jenc = jdelta.delta_encode(jnp.asarray(x), jnp.asarray(prev),
                               jnp.float32(scale), block_m=bm, block_k=bk,
                               compute_dtype=getattr(jnp, dtype))
    tenc = tdelta.delta_encode(t(x), t(prev), torch.tensor(scale), block_m=bm,
                               block_k=bk, compute_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(tenc.cur_q.numpy(), np.asarray(jenc.cur_q))
    np.testing.assert_array_equal(f32(tenc.delta), f32(jenc.delta))
    np.testing.assert_array_equal(tenc.block_mask.numpy(),
                                  np.asarray(jenc.block_mask))
    assert float(tenc.skip_fraction) == float(jenc.skip_fraction)


@pytest.mark.parametrize("gm,gk,p", [(4, 7, 0.5), (3, 12, 0.2), (2, 5, 1.0),
                                     (5, 1, 0.5), (6, 9, 0.0)])
def test_compact_rows_bitwise(rng, gm, gk, p):
    mask = (rng.random((gm, gk)) < p).astype(np.int32)
    jidx, jcnt = jdelta.compact_rows(jnp.asarray(mask))
    tidx, tcnt = tdelta.compact_rows(t(mask))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tidx.dtype == torch.int32 and tcnt.dtype == torch.int32


def test_compact_block_indices_count_zero():
    idx, count = tdelta.compact_block_indices(torch.zeros(6, dtype=torch.int32))
    assert int(count) == 0
    np.testing.assert_array_equal(idx.numpy(), np.zeros(6, np.int32))
    idx2, counts = tdelta.compact_rows(torch.tensor([[0, 0, 0], [0, 1, 0]],
                                                    dtype=torch.int32))
    np.testing.assert_array_equal(counts.numpy(), [0, 1])
    np.testing.assert_array_equal(idx2[1].numpy(), [1, 1, 1])
    np.testing.assert_array_equal(idx2[0].numpy(), [0, 0, 0])
    jidx, jcount = jdelta.compact_block_indices(jnp.zeros((6,), jnp.int32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
