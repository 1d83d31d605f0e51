"""The port's kernel modules against the JAX package's kernels.

On this CPU host each wrapper takes its plain PyTorch version (the tensors
lie on the CPU); the JAX side runs the Pallas kernels in interpret mode and
the compiled-XLA tier, as tests/test_kernels.py and tests/test_backend.py
run them. Tolerances are those of tests/test_kernels.py: rtol 1e-5 and atol
1e-4 for f32 GEMMs (the same products summed in another order), bitwise for
codes and masks. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.delta import delta_encode_int8 as jdelta_encode_int8
from repro.core.similarity import block_zero_mask as jblock_zero_mask
from repro.kernels import ops as jops
from repro.kernels import xla_tier
from repro.kernels.delta_quant import delta_quant as jdelta_quant
from repro.quant import quantize_int8 as jquantize_int8
from repro_torch.core.delta import compact_rows, delta_encode_int8
from repro_torch.core.similarity import block_zero_mask
from repro_torch.kernels import backend, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.delta_quant import (
    delta_quant,
    delta_quant_torch,
    vector_access,
)
from repro_torch.kernels.reuse_matmul import (
    reuse_matmul,
    reuse_matmul_torch,
    skip_sel,
    weight_dma_tiles,
)
from repro_torch.kernels.reuse_matmul_int8 import (
    reuse_matmul_int8,
    reuse_matmul_int8_torch,
)

RTOL, ATOL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def make_blocky_delta(rng, m, k, bm, bk, keep_prob, dtype=np.float32):
    """Delta tensor with a controlled fraction of all-zero tiles."""
    delta = rng.normal(size=(m, k)).astype(dtype)
    gm, gk = -(-m // bm), -(-k // bk)
    for i in range(gm):
        for j in range(gk):
            if rng.random() >= keep_prob:
                delta[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0.0
    return delta


def gemm_inputs(rng, m, k, n, bm, bk, keep):
    delta = make_blocky_delta(rng, m, k, bm, bk, keep)
    w = rng.normal(size=(k, n)).astype(np.float32)
    prev = rng.normal(size=(m, n)).astype(np.float32)
    mask = np.asarray(jblock_zero_mask(jnp.asarray(delta), bm, bk))
    return delta, w, prev, mask


# ------------------------------------------------------------- delta_quant

@pytest.mark.parametrize("m,k,bm,bk", [(32, 512, 8, 128), (64, 256, 16, 256),
                                       (8, 1024, 8, 256)])
@pytest.mark.parametrize("delta_dtype", ["float32", "bfloat16"])
def test_delta_quant_vs_pallas_and_xla(rng, m, k, bm, bk, delta_dtype):
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[rng.random((m, k)) < 0.2] = (rng.integers(-50, 50) + 0.5) * 0.0625
    prev_q = np.asarray(jquantize_int8(
        jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)),
        jnp.float32(0.0625)))
    prev_q = np.where(rng.random((m, k)) < 0.5,
                      np.asarray(jquantize_int8(jnp.asarray(x),
                                                jnp.float32(0.0625))),
                      prev_q)
    prev_q[:bm, :bk] = np.asarray(jquantize_int8(jnp.asarray(x[:bm, :bk]),
                                                 jnp.float32(0.0625)))
    s = np.float32(0.0625)
    jdt = getattr(jnp, delta_dtype)
    q1, d1, m1 = jdelta_quant(jnp.asarray(x), jnp.asarray(prev_q),
                              jnp.float32(s), block_m=bm, block_k=bk,
                              delta_dtype=jdt, interpret=True)
    q2, d2, m2 = xla_tier.delta_quant_xla(
        jnp.asarray(x), jnp.asarray(prev_q), jnp.float32(s), block_m=bm,
        block_k=bk, delta_dtype=jdt)
    q, d, msk = delta_quant(t(x), t(prev_q), torch.tensor(s), block_m=bm,
                            block_k=bk, delta_dtype=getattr(torch, delta_dtype))
    for jq, jm in ((q1, m1), (q2, m2)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(msk.numpy(), np.asarray(jm))
    assert not msk.all() and msk.any()
    # the oracle of the delta is the XLA tier, which follows delta_dtype
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(d2, np.float32))
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(d1, np.float32))


@pytest.mark.parametrize("m,k,bm,bk", [(10, 300, 8, 128), (3, 64, 8, 256)])
def test_delta_quant_fused_padding_vs_reference(rng, m, k, bm, bk):
    x = rng.normal(size=(m, k)).astype(np.float32)
    prev_q = rng.integers(-3, 4, size=(m, k)).astype(np.int8)
    s = np.float32(0.05)
    jq, jd, jm = jops.delta_quant_fused(
        jnp.asarray(x), jnp.asarray(prev_q), jnp.float32(s), block_m=bm,
        block_k=bk, delta_dtype=jnp.float32, interpret=True)
    for impl in ("cuda", "torch"):
        q, d, msk = ops.delta_quant_fused(
            t(x), t(prev_q), torch.tensor(s), block_m=bm, block_k=bk,
            delta_dtype=torch.float32, impl=impl)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(msk.numpy(), np.asarray(jm))


@pytest.mark.parametrize("ptrs,bk,want", [
    ((0, 4096, 1 << 20, 48), 256, True),     # aligned, the serve's tile
    ((0, 4096, 1 << 20, 48), 64, True),
    ((2, 4096, 1 << 20, 48), 256, False),    # bf16 x one element in
    ((0, 4099, 1 << 20, 48), 256, False),    # prev_q three bytes in
    ((0, 4096, 1 << 20, 48), 100, False),    # rows of 100: tiles unaligned
    ((0, 4096, 1 << 20, 52), 128, False),
])
def test_delta_quant_vector_access_needs_alignment(ptrs, bk, want):
    """The wrapper takes the kernel's 8-wide vector instance only when every
    pointer is 16-byte aligned and block_k % 8 == 0; else the scalar one."""
    assert vector_access(ptrs, bk) is want


def test_delta_quant_ref_casts_delta_to_bf16(rng):
    x = rng.normal(size=(16, 256)).astype(np.float32)
    prev_q = rng.integers(-3, 4, size=(16, 256)).astype(np.int8)
    q, d, msk = tref.delta_quant_ref(t(x), t(prev_q), torch.tensor(0.05), 8, 128)
    jq, jd, jm = jops.delta_quant_ref(jnp.asarray(x), jnp.asarray(prev_q),
                                      jnp.float32(0.05), 8, 128)
    assert d.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(d.float().numpy(), np.asarray(jd, np.float32))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jm))


# ------------------------------------------------------------ reuse_matmul

SWEEP = [
    # (M, K, N, bm, bn, bk, keep) — a subset of tests/test_kernels.py::SWEEP
    (32, 256, 128, 8, 128, 128, 0.5),
    (64, 512, 256, 32, 128, 128, 0.3),
    (8, 256, 384, 8, 128, 128, 0.0),    # fully skippable
    (16, 512, 128, 16, 128, 512, 1.0),  # nothing skippable
    (24, 384, 128, 8, 128, 128, 0.4),
]


@pytest.mark.parametrize("m,k,n,bm,bn,bk,keep", SWEEP)
@pytest.mark.parametrize("dataflow", ["output", "input"])
def test_reuse_matmul_vs_pallas(rng, m, k, n, bm, bn, bk, keep, dataflow):
    delta, w, prev, mask = gemm_inputs(rng, m, k, n, bm, bk, keep)
    want = jops.reuse_matmul(
        jnp.asarray(delta), jnp.asarray(w), jnp.asarray(prev),
        jnp.asarray(mask), block_m=bm, block_n=bn, block_k=bk,
        dataflow=dataflow, interpret=True)
    for impl in ("cuda", "torch"):
        out = ops.reuse_matmul(t(delta), t(w), t(prev), t(mask), block_m=bm,
                               block_n=bn, block_k=bk, dataflow=dataflow,
                               impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_reuse_matmul_bf16_vs_pallas(rng):
    m, k, n, bm, bn, bk = 32, 512, 256, 8, 128, 128
    delta, w, prev, mask = gemm_inputs(rng, m, k, n, bm, bk, 0.5)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jops.reuse_matmul(jb(delta), jb(w), jnp.asarray(prev),
                             jnp.asarray(mask), block_m=bm, block_n=bn,
                             block_k=bk, interpret=True)
    out = ops.reuse_matmul(t(delta).bfloat16(), t(w).bfloat16(), t(prev),
                           t(mask), block_m=bm, block_n=bn, block_k=bk)
    # bf16 products are exact in f32: only the summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_mask_zero_blocks_never_loaded_semantics(rng):
    """Masked tiles contribute nothing even where delta is nonzero: the
    kernel consumes the MASK (load skip), not the data."""
    m, k, n, bm, bk = 16, 512, 128, 8, 128
    delta = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    prev = np.zeros((m, n), np.float32)
    mask = np.zeros((m // bm, k // bk), np.int32)
    mask[0, 1] = 1
    for dataflow in ("output", "input"):
        out = reuse_matmul(t(delta), t(w), t(prev), t(mask), block_m=bm,
                           block_n=128, block_k=bk, dataflow=dataflow)
        want = tref.reuse_matmul_ref(t(delta), t(w), t(prev), t(mask), bm, bk)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        assert not np.allclose(out.numpy(), prev + delta @ w)


def test_skip_sel_and_weight_dma_tiles_match_reference(rng):
    from repro.kernels.reuse_matmul import skip_sel as jskip_sel
    from repro.kernels.reuse_matmul import weight_dma_tiles as jdma

    mask = np.asarray([[0, 1, 0, 0, 1], [1, 0, 0, 1, 0]], np.int32)
    np.testing.assert_array_equal(skip_sel(t(mask)).numpy(),
                                  [[0, 1, 1, 1, 4], [0, 0, 0, 3, 3]])
    for trial in range(6):
        mask = (rng.random((3, 7)) < 0.2 * trial).astype(np.int32)
        np.testing.assert_array_equal(skip_sel(t(mask)).numpy(),
                                      np.asarray(jskip_sel(jnp.asarray(mask))))
        for dataflow in ("output", "input"):
            got = weight_dma_tiles(t(mask), gn=5, dataflow=dataflow)
            assert got.dtype == torch.int32
            assert int(got) == int(jdma(jnp.asarray(mask), gn=5,
                                        dataflow=dataflow))


# ----------------------------------------------------------------- ragged

RAGGED_SWEEP = [
    # (M, K, N, bm, bn, bk, keep, budget) — tests/test_kernels.py::RAGGED_SWEEP
    (32, 1024, 256, 8, 128, 128, 0.3, None),   # ragged counts, full extent
    (32, 1024, 256, 8, 128, 128, 0.3, 4),      # ragged counts, tight budget
    (16, 512, 128, 8, 128, 128, 0.0, 1),       # all rows skipped
    (16, 512, 128, 8, 128, 128, 1.0, 2),       # all rows computed (overflow)
    (24, 384, 128, 8, 128, 128, 0.4, 2),       # non-multiple K via ops pad
    (20, 300, 130, 8, 128, 128, 0.5, None),    # every dim non-multiple
]


@pytest.mark.parametrize("m,k,n,bm,bn,bk,keep,budget", RAGGED_SWEEP)
def test_reuse_matmul_ragged_vs_pallas(rng, m, k, n, bm, bn, bk, keep, budget):
    delta, w, prev, mask = gemm_inputs(rng, m, k, n, bm, bk, keep)
    want = jops.reuse_matmul_ragged(
        jnp.asarray(delta), jnp.asarray(w), jnp.asarray(prev),
        jnp.asarray(mask), block_m=bm, block_n=bn, block_k=bk,
        max_active_k=budget, interpret=True)
    for impl in ("cuda", "torch"):
        out = ops.reuse_matmul_ragged(
            t(delta), t(w), t(prev), t(mask), block_m=bm, block_n=bn,
            block_k=bk, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_ragged_all_rows_skipped_passes_prev_through(rng):
    m, k, n, bm, bk = 16, 512, 128, 8, 128
    delta = np.zeros((m, k), np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    prev = rng.normal(size=(m, n)).astype(np.float32)
    mask = np.zeros((m // bm, k // bk), np.int32)
    out = ops.reuse_matmul_ragged(t(delta), t(w), t(prev), t(mask), block_m=bm,
                                  block_n=128, block_k=bk)
    np.testing.assert_array_equal(out.numpy(), prev)


def test_ragged_budget_overflow_falls_back_exactly(rng):
    """Where the live counts overflow the reference's budget (its full-extent
    fallback), the budget-free walk adds the same tiles: no contribution is
    dropped."""
    m, k, n, bm, bk = 8, 512, 128, 8, 128
    delta, w, prev, mask = gemm_inputs(rng, m, k, n, bm, bk, 1.0)
    assert int(mask.sum(axis=1).max()) == 4
    want = tref.reuse_matmul_ref(t(delta), t(w), t(prev), t(mask), bm, bk)
    fallback = jops.reuse_matmul_ragged(
        jnp.asarray(delta), jnp.asarray(w), jnp.asarray(prev),
        jnp.asarray(mask), block_m=bm, block_n=128, block_k=bk,
        max_active_k=1, interpret=True)
    out = ops.reuse_matmul_ragged(t(delta), t(w), t(prev), t(mask), block_m=bm,
                                  block_n=128, block_k=bk)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(fallback), rtol=RTOL,
                               atol=ATOL)


def test_ragged_consumes_mask_not_data(rng):
    m, k, n, bm, bk = 16, 512, 128, 8, 128
    delta = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    prev = np.zeros((m, n), np.float32)
    mask = np.zeros((m // bm, k // bk), np.int32)
    mask[0, 2] = 1
    out = ops.reuse_matmul_ragged(t(delta), t(w), t(prev), t(mask), block_m=bm,
                                  block_n=128, block_k=bk)
    want = tref.reuse_matmul_ref(t(delta), t(w), t(prev), t(mask), bm, bk)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert not np.allclose(out.numpy(), prev + delta @ w)


@pytest.mark.parametrize("gm,gk,p,budget", [(4, 8, 0.3, 3), (4, 8, 0.9, 3),
                                            (2, 5, 0.5, None), (3, 6, 0.0, 1)])
def test_ragged_accounting_matches_reference(rng, gm, gk, p, budget):
    mask = (rng.random((gm, gk)) < p).astype(np.int32)
    _, counts = compact_rows(t(mask))
    jcounts = jnp.asarray(counts.numpy())
    assert int(ops.ragged_dma_tiles(counts, gn=3)) == int(
        jops.ragged_dma_tiles(jcounts, gn=3))
    g = ops.ragged_grid_steps(counts, gm=gm, gn=3, gk=gk, max_active_k=budget)
    assert g.dtype == torch.float32
    assert float(g) == float(jops.ragged_grid_steps(
        jcounts, gm=gm, gn=3, gk=gk, max_active_k=budget))
    o = ops.budget_overflow(counts, gk=gk, max_active_k=budget)
    assert o.dtype == torch.int32
    assert int(o) == int(jops.budget_overflow(jcounts, gk=gk,
                                              max_active_k=budget))
    assert ops.clamp_budget(budget, gk) == jops.clamp_budget(budget, gk)


# ------------------------------------------------------- int8 split GEMM

def int8_codes(rng, m, k, keep, overflow):
    """cur/prev int8 codes: a `keep` share of the (8, 64) tiles changed by
    at most 100, and with `overflow` some codes jump by more than 127."""
    prev = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    cur = prev.astype(np.int32)
    for i in range(0, m, 8):
        for j in range(0, k, 64):
            if rng.random() < keep:
                tile = cur[i:i + 8, j:j + 64]
                tile += rng.integers(-50, 51, size=tile.shape)
    cur = np.clip(cur, -127, 127).astype(np.int8)
    if overflow:
        cur[0, :5] = 127
        prev[0, :5] = -127
    return cur, prev


@pytest.mark.parametrize("m,k,bm,bk,overflow", [
    (16, 256, 8, 64, True), (32, 512, 8, 128, False), (10, 300, 8, 128, True),
    (128, 256, 128, 256, True)])
def test_delta_encode_int8_matches_reference(rng, m, k, bm, bk, overflow):
    cur, prev = int8_codes(rng, m, k, 0.5, overflow)
    want = jdelta_encode_int8(jnp.asarray(cur), jnp.asarray(prev), block_m=bm,
                              block_k=bk)
    got = delta_encode_int8(t(cur), t(prev), block_m=bm, block_k=bk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    assert bool(got.has_overflow) == overflow
    np.testing.assert_array_equal(
        got.lo.numpy().astype(np.int32) + got.hi.numpy(),
        cur.astype(np.int32) - prev)


@pytest.mark.parametrize("m,k,n,bm,bn,bk,keep", [
    (16, 512, 256, 8, 128, 128, 0.5),
    (32, 256, 128, 8, 128, 64, 0.2),
    (128, 512, 256, 128, 128, 256, 0.6),   # block_m 128, the ops default
    (20, 300, 130, 8, 128, 128, 0.5),      # every dim non-multiple (ops pad)
    (16, 256, 128, 8, 128, 128, 0.0),      # nothing changed: prev passes
])
def test_reuse_matmul_int8_split_matches_pallas(rng, m, k, n, bm, bn, bk, keep):
    """lo then hi through the int8 GEMM, chained as the reference's callers
    chain it: bitwise equal to the Pallas kernel (interpret mode) and to the
    exact int32 product of the code delta."""
    cur, prev = int8_codes(rng, m, k, keep, overflow=keep > 0)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    acc = rng.integers(-1000, 1000, size=(m, n)).astype(np.int32)
    jenc = jdelta_encode_int8(jnp.asarray(cur), jnp.asarray(prev), block_m=bm,
                              block_k=bk)
    jlo = jops.reuse_matmul_int8(jenc.lo, jnp.asarray(wq), jnp.asarray(acc),
                                 jenc.lo_mask, block_m=bm, block_n=bn,
                                 block_k=bk, interpret=True)
    jout = jops.reuse_matmul_int8(jenc.hi, jnp.asarray(wq), jlo, jenc.hi_mask,
                                  block_m=bm, block_n=bn, block_k=bk,
                                  interpret=True)
    exact = acc + (cur.astype(np.int64) - prev) @ wq.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(jout), exact)
    enc = delta_encode_int8(t(cur), t(prev), block_m=bm, block_k=bk)
    for impl in ("cuda", "torch"):
        lo = ops.reuse_matmul_int8(enc.lo, t(wq), t(acc), enc.lo_mask,
                                   block_m=bm, block_n=bn, block_k=bk,
                                   impl=impl)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        out = ops.reuse_matmul_int8(enc.hi, t(wq), lo, enc.hi_mask,
                                    block_m=bm, block_n=bn, block_k=bk,
                                    impl=impl)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_reuse_matmul_int8_consumes_mask_and_matches_oracles(rng):
    m, k, n, bm, bk = 16, 256, 128, 8, 128
    d = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    acc = rng.integers(-1000, 1000, size=(m, n)).astype(np.int32)
    mask = np.asarray([[1, 0], [0, 1]], np.int32)
    want = jops.reuse_matmul_int8_ref(jnp.asarray(d), jnp.asarray(wq),
                                      jnp.asarray(acc), jnp.asarray(mask),
                                      bm, bk)
    for got in (tref.reuse_matmul_int8_ref(t(d), t(wq), t(acc), t(mask), bm, bk),
                reuse_matmul_int8_torch(t(d), t(wq), t(acc), t(mask),
                                        block_m=bm, block_k=bk),
                reuse_matmul_int8(t(d), t(wq), t(acc), t(mask), block_m=bm,
                                  block_n=128, block_k=bk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(np.asarray(want),
                              acc + d.astype(np.int32) @ wq.astype(np.int32))


# --------------------------------------------------------- wrapper contract

def test_wrappers_reject_non_tile_multiples_and_unknown_devices(rng):
    x = torch.zeros((8, 200))
    with pytest.raises(ValueError, match="multiple"):
        delta_quant(x, torch.zeros((8, 200), dtype=torch.int8),
                    torch.tensor(0.05), block_m=8, block_k=128)
    with pytest.raises(ValueError, match="device"):
        delta_quant(torch.zeros((8, 128), device="meta"),
                    torch.zeros((8, 128), dtype=torch.int8, device="meta"),
                    torch.tensor(0.05, device="meta"), block_m=8, block_k=128)
    with pytest.raises(ValueError, match="dataflow"):
        reuse_matmul(torch.zeros((8, 128)), torch.zeros((128, 128)),
                     torch.zeros((8, 128)), torch.zeros((1, 1), dtype=torch.int32),
                     block_m=8, block_n=128, block_k=128, dataflow="diagonal")
    with pytest.raises(ValueError, match="impl"):
        ops.reuse_matmul(torch.zeros((8, 128)), torch.zeros((128, 128)),
                         torch.zeros((8, 128)),
                         torch.zeros((1, 1), dtype=torch.int32), impl="jnp")
    i8 = torch.zeros((8, 200), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple"):
        reuse_matmul_int8(i8, torch.zeros((200, 128), dtype=torch.int8),
                          torch.zeros((8, 128), dtype=torch.int32),
                          torch.zeros((1, 1), dtype=torch.int32), block_m=8,
                          block_k=128)
    with pytest.raises(ValueError, match="mask"):
        ops.reuse_matmul_int8(i8, torch.zeros((200, 128), dtype=torch.int8),
                              torch.zeros((8, 128), dtype=torch.int32),
                              torch.zeros((1, 1), dtype=torch.int32),
                              block_m=8, block_k=128)


@pytest.mark.parametrize("bm,bn,bk,bad", [
    (8, 128, 256, None), (16, 256, 32, None), (128, 128, 256, None),
    (12, 128, 256, "block_m"), (8, 64, 256, "block_n"),
    (8, 128, 48, "block_k")])
def test_int8_kernel_tiling_contract(bm, bn, bk, bad):
    """The tensor-core kernel's tiles: m in 8-row MMA tiles, n in 128-column
    CTA tiles, k in the 32-deep steps of m16n8k32 (the skip's granularity).
    The contract is checked before any launch, so it holds on the CPU."""
    from repro_torch.kernels import reuse_matmul_int8 as ri

    args = (torch.zeros((bm, bk), dtype=torch.int8),
            torch.zeros((bk, bn), dtype=torch.int8),
            torch.zeros((bm, bn), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32))
    if bad is None:
        ri._check(*args, bm, bn, bk)
    else:
        with pytest.raises(ValueError, match=f"{bad} %"):
            ri._check(*args, bm, bn, bk)


@pytest.mark.parametrize("bm,bn,bk,bad", [
    (8, 128, 256, None), (16, 256, 64, None), (128, 128, 128, None),
    (12, 128, 256, "block_m"), (8, 64, 256, "block_n"),
    (8, 128, 96, "block_k"), (8, 128, 32, "block_k")])
def test_input_stationary_tiling_contract(bm, bn, bk, bad):
    """The tiles of the cluster tile loop, which the input-stationary kernel
    shares with the output-stationary and ragged ones: 8-row m tiles inside
    one block_m group, 128-column CTA tiles, k dealt to the cluster's ranks
    in 64-row sub-steps. A broken divisor raises ValueError naming it (and
    no other) before any launch, so the contract holds on the CPU."""
    from repro_torch.kernels import reuse_matmul as rm

    args = (torch.zeros((bm, bk), dtype=torch.bfloat16),
            torch.zeros((bk, bn), dtype=torch.bfloat16),
            torch.zeros((bm, bn)), bm, bk, bn)
    for what in ("reuse_matmul(input)", "reuse_matmul(output)",
                 "reuse_matmul_ragged"):
        if bad is None:
            rm.check_gemm(*args, what)
            continue
        with pytest.raises(ValueError, match=f"{bad} %") as err:
            rm.check_gemm(*args, what)
        others = {"block_m", "block_n", "block_k"} - {bad}
        assert not any(o in str(err.value) for o in others), err.value


# (k, n) of every output-stationary site of both archetypes at decode batch
# 8, with the k split k_split gives it on a 132-SM H100
SITE_SPLITS = {
    "rwkv6 wr/wk/wv/wg/wo, cmix_wr": (4096, 4096, 4),
    "rwkv6 cmix_wk": (4096, 14336, 2),
    "rwkv6 cmix_wv": (14336, 4096, 4),
    "qwen3 attn_qkv": (5120, 10240, 2),
    "qwen3 attn_out": (8192, 5120, 4),
    "qwen3 mlp_in": (5120, 51200, 1),
}


@pytest.mark.parametrize("site", list(SITE_SPLITS))
def test_k_split_at_every_site(site):
    """The cluster size is one of the launchable ones, gives SM_FILL of the
    SMs a CTA where the sub-steps allow (and no smaller one does), and never
    exceeds the tile's 64-row sub-steps."""
    from repro_torch.kernels import reuse_matmul as rm

    k, n, want = SITE_SPLITS[site]
    c = rm.k_split(8, n, k, 132)
    assert c == want
    assert c in rm.CLUSTERS and c <= k // rm.SUB_K
    tiles = n // rm.COLS_PER_CTA
    smaller = [s for s in rm.CLUSTERS if s < c]
    assert all(tiles * s < rm.SM_FILL * 132 for s in smaller)


def test_k_split_caps_at_the_sub_steps():
    from repro_torch.kernels import reuse_matmul as rm

    assert rm.k_split(8, 128, 64, 132) == 1     # one sub-step
    assert rm.k_split(8, 128, 256, 132) == 4    # four sub-steps
    assert rm.k_split(8, 128, 4096, 132) == 8
    assert rm.k_split(64, 2048, 4096, 132) == 1  # 128 tiles fill the card


def test_import_builds_nothing_and_counts_start_at_zero():
    backend.reset_launches()
    assert backend.launch_counts() == {k: 0 for k in backend.KERNELS}
    assert backend.best() in ("cuda", "torch")
    assert set(backend.tag()) == {"backend", "torch", "cuda", "device",
                                  "device_name"}


def test_block_zero_mask_matches_delta_quant_mask(rng):
    x = rng.normal(size=(16, 512)).astype(np.float32)
    prev_q = rng.integers(-2, 3, size=(16, 512)).astype(np.int8)
    q, _, msk = delta_quant_torch(t(x), t(prev_q), torch.tensor(0.05),
                                  block_m=8, block_k=128)
    dq = q.to(torch.int32) - t(prev_q).to(torch.int32)
    assert torch.equal(block_zero_mask(dq, 8, 128), msk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reuse_matmul_masked_matches_reference_and_plain(rng, dtype):
    """The branchless software-reuse product: the full product of the
    zero-masked Δ. Equal to the masked plain version at a mask of all ones
    and, in f32, to the reference's jnp product."""
    m, k, n = 8, 384, 256
    delta = rng.normal(size=(m, k)).astype(np.float32)
    delta[rng.random((m, k)) < 0.6] = 0.0
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    prev = rng.normal(size=(m, n)).astype(np.float32)
    td, tw = torch.from_numpy(delta).to(dtype), torch.from_numpy(w).to(dtype)
    got = ops.reuse_matmul_masked(td, tw, torch.from_numpy(prev))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    ones = torch.ones((1, k // 128), dtype=torch.int32)
    want = reuse_matmul_torch(td, tw, torch.from_numpy(prev), ones,
                              block_m=8, block_k=128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)
    if dtype == torch.float32:
        ref = jops.reuse_matmul_masked(jnp.asarray(delta), jnp.asarray(w),
                                       jnp.asarray(prev))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-5)
