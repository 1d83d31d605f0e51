"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serve path through them. Marked `gpu`; each test skips
without a CUDA device of capability >= 9.0, deciding inside a fixture.
This file imports no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.control import ControlConfig, Controller
from repro_torch.core.delta import compact_rows, delta_encode_int8
from repro_torch.core.policy import ReusePolicy, SiteTunables
from repro_torch.guard import FaultInjector, QuarantineBreaker
from repro_torch.kernels import backend, ops
from repro_torch.kernels.delta_quant import (
    delta_quant,
    delta_quant_torch,
    vector_access,
)
from repro_torch.kernels.reuse_matmul import reuse_matmul, reuse_matmul_torch
from repro_torch.kernels.reuse_matmul_int8 import reuse_matmul_int8_torch
from repro_torch.kernels.reuse_matmul_ragged import (
    reuse_matmul_ragged,
    reuse_matmul_ragged_torch,
)
from repro_torch.kernels.wkv6_decode import wkv6_decode, wkv6_decode_torch
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import init_params
from repro_torch.sensor.runner import run_measured_decode
from repro_torch.serve.compiled_step import CompiledStep
from repro_torch.serve.serve_step import build_reuse_engine, init_serve_state
from repro_torch.tune import (
    FitConfig,
    fit_trace,
    load_trace,
    load_tuned_policy,
    save_table,
)

# f32 GEMMs as tests/test_kernels.py: the same products summed in another order
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of capability >= 9.0 (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dataflow", ["output", "input", "ragged"])
def test_gemm_kernels_match_plain_on_card(card, dtype, dataflow):
    gen = torch.Generator(device=card).manual_seed(0)
    m, k, n, bm, bk = 16, 1024, 256, 8, 256
    mask = (torch.rand((m // bm, k // bk), generator=gen, device=card)
            < 0.5).to(torch.int32)
    mask[1] = 0
    em = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    delta = (torch.randn((m, k), generator=gen, device=card) * em).to(dtype)
    w = torch.randn((k, n), generator=gen, device=card).to(dtype)
    prev = torch.randn((m, n), generator=gen, device=card)
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=bm, block_k=bk)
    before = backend.launch_counts()
    if dataflow == "ragged":
        idx, counts = compact_rows(mask)
        out = reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=bm,
                                  block_n=128, block_k=bk)
        plain = reuse_matmul_ragged_torch(delta, w, prev, counts, idx,
                                          block_m=bm, block_n=128, block_k=bk)
        torch.testing.assert_close(plain, want, rtol=RTOL, atol=ATOL)
        name = "reuse_matmul_ragged"
    else:
        out = reuse_matmul(delta, w, prev, mask, block_m=bm, block_n=128,
                           block_k=bk, dataflow=dataflow)
        name = f"reuse_matmul_{dataflow}"
    torch.cuda.synchronize()
    assert backend.launch_counts()[name] == before[name] + 1
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(out[8:], prev[8:], rtol=0, atol=0)


# name: (m, k, n, block_m, block_k, mask). The input-stationary kernel splits
# each (8-row, 128-column) tile's active k tiles, in 64-row sub-steps, over a
# cluster of 8 CTAs and sums their partials in rank order.
INPUT_CASES = {
    "gk_5": (8, 1280, 256, 8, 256, "all"),      # 20 sub-steps: runs of 2, 3
    "one_tile": (8, 1024, 256, 8, 256, "one"),  # 4 sub-steps: 4 ranks idle
    "all_masked": (8, 1024, 256, 8, 256, "none"),
    "two_rows": (16, 2048, 384, 8, 128, "rows"),
    "n_128": (8, 1024, 128, 8, 64, 0.5),        # one column tile
    "block_m_16": (32, 1024, 256, 16, 256, 0.5),
    "mlp_out": (8, 25600, 5120, 8, 256, 0.0),   # qwen3-32b decode
    "mlp_out_skip": (8, 25600, 5120, 8, 256, 0.78),
}


def input_mask(rule, gm, gk, gen, dev):
    mask = torch.ones((gm, gk), dtype=torch.int32, device=dev)
    if rule == "one":
        mask[:] = 0
        mask[:, 2] = 1
    elif rule == "none":
        mask[:] = 0
    elif rule == "first":  # row 0 keeps every tile, the rest keep none
        mask[1:] = 0
    elif rule == "rows":  # row 0 keeps even tiles, row 1 every third
        mask[0, 1::2] = 0
        mask[1] = (torch.arange(gk, device=dev) % 3 == 1).to(torch.int32)
    elif isinstance(rule, float):  # exactly round(rule · gm · gk) zeros
        flat = mask.view(-1)
        flat[torch.randperm(flat.numel(), generator=gen,
                            device=dev)[:round(rule * flat.numel())]] = 0
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INPUT_CASES))
def test_input_stationary_on_card(card, dtype, case):
    """Against the plain version at this file's tolerances, one launch per
    call, and bitwise equal from run to run (the cluster sums its ranks'
    partials in a fixed order, with no atomics). Δ is nonzero in masked
    tiles too, so a kernel that read a masked tile, or another m tile's
    mask row ("two_rows"), would disagree."""
    m, k, n, bm, bk, rule = INPUT_CASES[case]
    gen = torch.Generator(device=card).manual_seed(0)
    mask = input_mask(rule, m // bm, k // bk, gen, card)
    delta = torch.randn((m, k), generator=gen, device=card).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=card) / k ** 0.5).to(dtype)
    prev = torch.randn((m, n), generator=gen, device=card)
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=bm, block_k=bk)
    outs = []
    for _ in range(2):
        before = backend.launch_counts()["reuse_matmul_input"]
        outs.append(reuse_matmul(delta, w, prev, mask, block_m=bm,
                                 block_n=128, block_k=bk, dataflow="input"))
        torch.cuda.synchronize()
        assert backend.launch_counts()["reuse_matmul_input"] == before + 1
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    assert torch.equal(outs[0], outs[1])
    if rule == "none":
        assert torch.equal(outs[0], prev)


def masked_or_ragged(kernel, delta, w, prev, mask, bm, bk):
    """One launch of the output-stationary or the ragged kernel (the ragged
    list is the mask compacted), checked to be one launch."""
    name = f"reuse_matmul_{kernel}"
    before = backend.launch_counts()[name]
    if kernel == "ragged":
        idx, counts = compact_rows(mask)
        out = reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=bm,
                                  block_n=128, block_k=bk)
    else:
        out = reuse_matmul(delta, w, prev, mask, block_m=bm, block_n=128,
                           block_k=bk, dataflow="output")
    torch.cuda.synchronize()
    assert backend.launch_counts()[name] == before + 1
    return out


def check_cluster_gemm(kernel, m, k, n, bm, bk, rule, dtype, dev, seed=0):
    """Against the plain version at this file's tolerances, and bitwise equal
    from run to run (fixed deal, rank-order reduction, no atomics). Δ is
    nonzero in masked tiles too, so a kernel that read a masked tile, or
    another m tile's list, would disagree; an all-masked row passes
    prev_out through bitwise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = input_mask(rule, m // bm, k // bk, gen, dev)
    delta = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
    prev = torch.randn((m, n), generator=gen, device=dev)
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=bm, block_k=bk)
    outs = [masked_or_ragged(kernel, delta, w, prev, mask, bm, bk)
            for _ in range(2)]
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    assert torch.equal(outs[0], outs[1])
    for mb in range(m // bm):
        if not bool(mask[mb].any()):
            rows = slice(mb * bm, (mb + 1) * bm)
            assert torch.equal(outs[0][rows], prev[rows])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["output", "ragged"])
@pytest.mark.parametrize("case", list(INPUT_CASES))
def test_output_and_ragged_cases_on_card(card, dtype, kernel, case):
    """The input-stationary cases through the two kernels that share its
    tile loop and pick their k split from the shape."""
    m, k, n, bm, bk, rule = INPUT_CASES[case]
    check_cluster_gemm(kernel, m, k, n, bm, bk, rule, dtype, card)


# (k, n) of every output-stationary site of both archetypes at decode batch 8
SITE_SHAPES = {
    "rwkv6_4096": (4096, 4096),     # wr, wk, wv, wg, wo, cmix_wr
    "rwkv6_cmix_wk": (4096, 14336),
    "rwkv6_cmix_wv": (14336, 4096),
    "qwen3_attn_qkv": (5120, 10240),
    "qwen3_attn_out": (8192, 5120),
    "qwen3_mlp_in": (5120, 51200),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["output", "ragged"])
@pytest.mark.parametrize("site", list(SITE_SHAPES))
def test_output_and_ragged_at_site_shapes_on_card(card, dtype, kernel, site):
    k, n = SITE_SHAPES[site]
    for seed, skip in enumerate((0.0, 0.5, 0.78, 1.0)):
        check_cluster_gemm(kernel, 8, k, n, 8, 256, skip, dtype, card, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_each_k_split_on_card(card, dtype, cluster):
    """A shape for each cluster size k_split can pick on this card: the
    fewest column tiles with which it picks `cluster`, two 8-row m tiles of
    which the second is all masked, and 20 sub-steps (runs of 2 and 3)."""
    from repro_torch.kernels import reuse_matmul as rm

    n_sm = backend.sm_count(card.index)
    tiles = math.ceil(rm.SM_FILL * n_sm / cluster)
    m, k, n = 16, 1280, 128 * -(-tiles // 2)
    assert rm.k_split(m, n, k, n_sm) == cluster
    for kernel in ("output", "ragged"):
        check_cluster_gemm(kernel, m, k, n, 8, 256, "first", dtype, card)


# (m, kw, n, block_m, block_k, mask): the weight's kw rows end inside the
# last k tile (qwen2-72b's mlp_out, K = 29568 = 115.5 tiles of 256)
K_TAIL_CASES = {
    "tail_1000": (8, 1000, 256, 8, 256, 0.5),
    "tail_two_rows": (16, 1100, 384, 8, 128, "rows"),   # K = 1152
    "qwen2_mlp_out": (8, 29568, 8192, 8, 256, 0.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["output", "input", "ragged"])
@pytest.mark.parametrize("case", list(K_TAIL_CASES))
def test_k_tail_on_card(card, dtype, kernel, case):
    """Δ padded to whole tiles (zero past kw), the weight with its own kw
    rows: against the plain version at this file's tolerances, and bitwise
    the same kernel on the weight padded with zero rows, which the kernel's
    zero-filled copies stand for."""
    m, kw, n, bm, bk, rule = K_TAIL_CASES[case]
    k = -(-kw // bk) * bk
    gen = torch.Generator(device=card).manual_seed(3)
    mask = input_mask(rule, m // bm, k // bk, gen, card)
    delta = torch.randn((m, k), generator=gen, device=card).to(dtype)
    delta[:, kw:] = 0
    w = (torch.randn((kw, n), generator=gen, device=card)
         / kw ** 0.5).to(dtype)
    wpad = torch.cat([w, torch.zeros((k - kw, n), dtype=dtype,
                                      device=card)])
    prev = torch.randn((m, n), generator=gen, device=card)
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=bm, block_k=bk)

    def run(weight):
        if kernel == "input":
            return reuse_matmul(delta, weight, prev, mask, block_m=bm,
                                block_n=128, block_k=bk, dataflow="input")
        return masked_or_ragged(kernel, delta, weight, prev, mask, bm, bk)

    got = run(w)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, run(wpad))


# (k, n, dataflow) of sharded sites whose column panels the kernels read in
# place: qwen3-32b mlp_in and mlp_out (input-stationary, K > 4 N), qwen2-72b
# attn_qkv and mlp_in (at 4 shards 14,784 columns = 115.5 tiles: an N tail)
PANEL_SITES = {
    "qwen3_mlp_in": (5120, 51200, "output"),
    "qwen3_mlp_out": (25600, 5120, "input"),
    "qwen2_attn_qkv": (8192, 10240, "output"),
    "qwen2_mlp_in": (8192, 59136, "output"),
}


def panel_gemm(kernel, delta, w, prev, mask, n_total):
    """One launch of `kernel` ("output", "input" or "ragged") with the k
    split of `n_total` columns, checked to be one launch."""
    name = f"reuse_matmul_{kernel}"
    before = backend.launch_counts()[name]
    if kernel == "ragged":
        idx, counts = compact_rows(mask)
        out = reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=8,
                                  block_n=128, block_k=256, n_total=n_total)
    else:
        out = reuse_matmul(delta, w, prev, mask, block_m=8, block_n=128,
                           block_k=256, dataflow=kernel, n_total=n_total)
    torch.cuda.synchronize()
    assert backend.launch_counts()[name] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("site", list(PANEL_SITES))
def test_column_panel_on_card(card, site, ragged, shards):
    """A model-axis shard's panel `w[:, s·nl:(s+1)·nl]` read in place (row
    stride N) with the k split of the site's N: bitwise the unsharded
    kernel's columns of that panel, and bitwise the same kernel on a
    contiguous copy of the panel; bf16 at M = 8, skip 0.5."""
    k, n, dataflow = PANEL_SITES[site]
    kernel = "ragged" if ragged else dataflow
    nl = n // shards
    gen = torch.Generator(device=card).manual_seed(shards)
    mask = input_mask(0.5, 1, k // 256, gen, card)
    delta = torch.randn((8, k), generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=card)
         / k ** 0.5).to(torch.bfloat16)
    prev = torch.randn((8, n), generator=gen, device=card)
    whole = panel_gemm(kernel, delta, w, prev, mask, None)
    for s in range(shards):
        cols = slice(s * nl, (s + 1) * nl)
        pv = prev[:, cols].contiguous()
        got = panel_gemm(kernel, delta, w[:, cols], pv, mask, n)
        assert torch.equal(got, whole[:, cols]), s
        assert torch.equal(got, panel_gemm(
            kernel, delta, w[:, cols].contiguous(), pv, mask, n)), s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["output", "input", "ragged"])
@pytest.mark.parametrize("nl", [14784, 200, 8])
def test_n_tail_on_card(card, dtype, kernel, nl):
    """A panel whose columns end inside the last 128-column tile (qwen2-72b
    mlp_in at 4 shards; 1.56 tiles; 8 columns): within this file's
    tolerances of the plain version, and bitwise the kernel on the panel
    zero-padded to whole tiles, which its zero-filled copies stand for."""
    k = 2048
    gen = torch.Generator(device=card).manual_seed(nl)
    mask = input_mask(0.5, 1, k // 256, gen, card)
    delta = torch.randn((8, k), generator=gen, device=card).to(dtype)
    w = (torch.randn((k, 2 * nl), generator=gen, device=card)
         / k ** 0.5).to(dtype)
    panel = w[:, nl:]
    prev = torch.randn((8, nl), generator=gen, device=card)
    npad = -(-nl // 128) * 128
    wpad = torch.zeros((k, npad), dtype=dtype, device=card)
    wpad[:, :nl] = panel
    ppad = torch.zeros((8, npad), device=card)
    ppad[:, :nl] = prev
    got = panel_gemm(kernel, delta, panel, prev, mask, 2 * nl)
    want = reuse_matmul_torch(delta, panel, prev, mask, block_m=8,
                              block_k=256)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    padded = panel_gemm(kernel, delta, wpad, ppad, mask, 2 * nl)
    assert torch.equal(got, padded[:, :nl])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["output", "input", "ragged"])
def test_misaligned_panel_raises_on_card(card, kernel):
    """A panel whose base, row stride or width is not 16-byte aligned
    raises before any launch (bf16: multiples of 8 elements)."""
    gen = torch.Generator(device=card).manual_seed(0)
    mask = torch.ones((1, 4), dtype=torch.int32, device=card)
    delta = torch.randn((8, 1024), generator=gen, device=card).to(
        torch.bfloat16)
    w = torch.randn((1024, 1024), generator=gen, device=card).to(
        torch.bfloat16)
    for panel in (w[:, 4:132], w[:, :100], w.T):
        prev = torch.zeros((8, panel.shape[1]), device=card)
        before = backend.launch_counts()
        with pytest.raises(ValueError, match="aligned|row-major"):
            panel_gemm(kernel, delta, panel, prev, mask, 1024)
        assert backend.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-12b", "nemotron-4-15b"])
def test_lm_head_is_one_bf16_product_on_card(card, arch):
    """The full-width LM head (gemma3's tied 262,144 x 3840 embedding,
    nemotron's untied 6144 x 256,000 head): f32 logits of one bf16 product,
    equal to the widened f32 product within f32 summation order."""
    from repro_torch.models import output_logits

    cfg = get_config(arch)
    gen = torch.Generator(device=card).manual_seed(0)
    d, v = cfg.d_model, cfg.vocab
    params = {"final_norm": {"scale": torch.zeros(d, device=card)},
              "embed": (torch.randn((v, d), generator=gen, device=card)
                        * 0.01).to(BF16)}
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((d, v), generator=gen, device=card)
                             / d ** 0.5).to(BF16)
    h = torch.randn((8, 1, d), generator=gen, device=card).to(BF16)
    got = output_logits(params, cfg, h)
    head = params.get("lm_head", params["embed"].T)
    from repro_torch.models.layers import apply_norm

    want = (apply_norm(params["final_norm"], h, cfg.norm_eps).float()
            @ head.float())
    assert got.dtype == torch.float32 and got.shape == (8, 1, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


BF16, F32 = torch.bfloat16, torch.float32


def _offset_view(shape, dtype, card, offset):
    """A contiguous [M, K] view `offset` elements into a larger buffer, so its
    pointer is not 16-byte aligned (as a cache slice can be)."""
    n = shape[0] * shape[1]
    return torch.empty(n + offset, dtype=dtype, device=card)[offset:] \
        .view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["aligned", "offset", "clamp"])
@pytest.mark.parametrize("x_dtype,delta_dtype",
                         [(BF16, BF16), (BF16, F32), (F32, F32)])
@pytest.mark.parametrize("bm,bk", [(8, 256), (8, 64), (128, 256)])
@pytest.mark.parametrize("k", [4096, 14336, 25600])
def test_delta_quant_matches_plain_on_card(card, k, bm, bk, x_dtype,
                                           delta_dtype, case):
    """q, delta and mask bitwise at the serve widths (rwkv6 4096, 14336;
    qwen3 25600), the serve's tile, a narrow tile and the JAX default 128-row
    tile. "offset" puts x and prev_q at storage offsets that are not 16-byte
    aligned (the scalar instance); "clamp" drives |x / scale| past 127.
    Half-way codes exercise round-half-to-even. The left half of the columns
    keeps its codes, so its tiles are clean and the right half's dirty."""
    gen = torch.Generator(device=card).manual_seed(k + bm + bk)
    m, scale_v = (16 if bm == 8 else bm), 0.0625
    x = torch.randn((m, k), generator=gen, device=card) * 2.0
    half = (torch.randint(-100, 100, (m, k), generator=gen, device=card)
            + 0.5) * scale_v
    x = torch.where(torch.rand((m, k), generator=gen, device=card) < 0.25,
                    half, x)
    if case == "clamp":
        x = x * 100.0
    x = x.to(x_dtype)
    scale = torch.tensor(scale_v, device=card)
    prev_q = torch.randint(-127, 128, (m, k), generator=gen,
                           device=card).to(torch.int8)
    prev_q[:, :k // 2] = delta_quant_torch(
        x[:, :k // 2].contiguous(), prev_q[:, :k // 2].contiguous(), scale,
        block_m=bm, block_k=bk)[0]
    if case == "offset":
        x0, p0 = x, prev_q
        x = _offset_view((m, k), x_dtype, card, 1)
        prev_q = _offset_view((m, k), torch.int8, card, 3)
        x.copy_(x0)
        prev_q.copy_(p0)
    ptrs = (x.data_ptr(), prev_q.data_ptr())
    assert vector_access(ptrs, bk) == (case != "offset")
    before = backend.launch_counts()["delta_quant"]
    got = delta_quant(x, prev_q, scale, block_m=bm, block_k=bk,
                      delta_dtype=delta_dtype)
    torch.cuda.synchronize()
    assert backend.launch_counts()["delta_quant"] == before + 1
    want = delta_quant_torch(x, prev_q, scale, block_m=bm, block_k=bk,
                             delta_dtype=delta_dtype)
    for a, b, what in zip(got, want, ("q", "delta", "mask")):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    gk = k // bk
    assert int(got[2][:, :gk // 2].sum()) == 0
    assert bool(got[2][:, gk // 2:].all())
    if case == "clamp":
        assert int((got[0].abs() == 127).sum()) > m * k // 4


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,bm,bk,offset", [
    (8, 4096, 8, 512, 1),        # scalar: 512 columns, two column chunks
    (128, 8192, 128, 4096, 0),   # vector: 512 vectors a row, two chunks
    (128, 4096, 128, 256, 1),    # scalar: 16 rows a CTA, eight row chunks
])
def test_delta_quant_multi_chunk_tiles_on_card(card, m, k, bm, bk, offset):
    """Tiles a CTA walks in more than one chunk, bitwise."""
    gen = torch.Generator(device=card).manual_seed(bk + offset)
    x = _offset_view((m, k), BF16, card, offset)
    x.copy_(torch.randn((m, k), generator=gen, device=card) * 2.0)
    prev_q = _offset_view((m, k), torch.int8, card, 3 * offset)
    prev_q.copy_(torch.randint(-127, 128, (m, k), generator=gen, device=card))
    prev_q[:, :bk] = delta_quant_torch(
        x[:, :bk].contiguous(), prev_q[:, :bk].contiguous(),
        torch.tensor(0.05, device=card), block_m=bm, block_k=bk)[0]
    scale = torch.tensor(0.05, device=card)
    assert vector_access((x.data_ptr(), prev_q.data_ptr()), bk) == (not offset)
    got = delta_quant(x, prev_q, scale, block_m=bm, block_k=bk)
    want = delta_quant_torch(x, prev_q, scale, block_m=bm, block_k=bk)
    for a, b, what in zip(got, want, ("q", "delta", "mask")):
        assert torch.equal(a, b), what
    assert int(got[2][:, 0].sum()) == 0 and bool(got[2][:, 1:].all())


# ------------------------------------- a site call's bookkeeping (site_account)

# (k, n) of every serve site shape above, and K tails: a padded K (the codes
# a strided view, ldq > K) with 16-byte rows (3968) and without (3000)
ACCOUNT_SHAPES = {**SITE_SHAPES,
                  **{s: kn[:2] for s, kn in PANEL_SITES.items()},
                  "k_tail_vec": (3968, 4096), "k_tail_bytes": (3000, 4096)}
# (mode, path, dataflow, shards, budget) of every variant the serve runs
ACCOUNT_VARIANTS = (
    [("reuse", p, d, s, None) for p in ("kernel", "dense")
     for d in ("output", "input") for s in (0, 2, 4)]
    + [("reuse", p, "output", s, b) for p in ("ragged", "compact")
       for s in (0, 2, 4) for b in (1, None)]
    + [("basic", "kernel", d, s, None) for d in ("output", "input")
       for s in (0, 2, 4)])


def _account_inputs(card, m, k, n, seed):
    """(x, a cache entry with seeded lanes): the previous codes random, x
    the codes of a random half of the (8 × 256) tiles moved, as values the
    quantizer maps back to those codes exactly; the float lanes random
    with NaN and ±inf in some rows."""
    from repro_torch.core.reuse_cache import ReuseSiteSpec, init_site_cache

    gen = torch.Generator(device=card).manual_seed(seed)
    spec = ReuseSiteSpec("s", k, n, block_m=8, block_k=256)
    entry = init_site_cache(spec, m, device=card)
    prev = torch.randint(-100, 101, (m, k), generator=gen, device=card)
    gm, gk = -(-m // 8), -(-k // 256)
    moved = (torch.rand((gm, gk), generator=gen, device=card) < 0.5)
    moved = moved.repeat_interleave(8, 0).repeat_interleave(256, 1)[:m, :k]
    step = torch.randint(1, 6, (m, k), generator=gen, device=card)
    hit = torch.rand((m, k), generator=gen, device=card) < 0.3
    cur = torch.where(moved & hit, prev + step, prev)
    entry["prev_q"].copy_(prev)
    x = cur.float() * torch.tensor(0.05, device=card)
    for name, t in entry["sensor"].items():
        if t.is_floating_point():
            t.copy_(torch.rand(t.shape, generator=gen, device=card) * 3e7)
        else:
            t.copy_(torch.randint(0, 1000, t.shape, generator=gen,
                                  device=card))
    entry["sensor"]["mode_flag"].fill_(seed % 3 - 1)
    entry["sim_ema"].copy_(torch.rand((m,), generator=gen, device=card))
    entry["ctrl"]["occupancy"].fill_(0.37)
    bad = torch.tensor([math.nan, math.inf, -math.inf], device=card)
    entry["sim_ema"][:3] = bad[:m]
    entry["sensor"]["slot_hit_sum"][-3:] = bad[:m]
    return x, entry


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("site", list(ACCOUNT_SHAPES))
def test_site_account_matches_plain_on_card(card, site, m):
    """Every lane of a site call's bookkeeping bitwise the plain version's
    (NaN positions; NaN payloads are not compared), the match counts too,
    at every serve site shape and batch, over every exec path, dataflow,
    mode, shard count and budget (an int32 budget lane as the engine passes
    it, which overflows at 1), with NaN and ±inf in the lanes (every third
    variant also in every float scalar lane)."""
    from repro_torch.kernels import site_account as sa
    from repro_torch.sensor.counters import ShardCtx

    k, n = ACCOUNT_SHAPES[site]
    x, base = _account_inputs(card, m, k, n, seed=m + k)
    cur_q, _, mask = ops.delta_quant_fused(
        x, base["prev_q"], base["scale"], block_m=8, block_k=256,
        delta_dtype=BF16, impl="cuda")
    assert cur_q.stride(0) == -(-k // 256) * 256
    for i, (mode, path, dataflow, shards, budget) in enumerate(
            ACCOUNT_VARIANTS):
        got = sa.copy_lanes(base)
        if i % 3 == 0:
            for j, t in enumerate(sa.written_lanes(got).values()):
                if t.is_floating_point() and t.dim() == 0:
                    t.fill_((math.nan, math.inf, -math.inf)[j % 3])
        want = sa.copy_lanes(got)
        nl = n // shards if shards else n
        shard = (ShardCtx(shards - 1, shards, n, -(-n // 128))
                 if shards else None)
        lane = None if budget is None else torch.tensor(
            budget, dtype=torch.int32, device=card)
        kw = dict(path=path, dataflow=dataflow, block_m=8, block_k=256,
                  n=nl, gn=-(-nl // 128), w_itemsize=2, ema_decay=0.9,
                  budget=lane, shard=shard)
        bm = None if mode == "basic" else mask
        before = backend.launch_counts()["site_account"]
        matches = sa.site_account(cur_q, bm, got, **kw)
        want_m = sa.site_account_torch(cur_q, bm, want, **kw)
        torch.cuda.synchronize()
        assert backend.launch_counts()["site_account"] == before + 1
        what = (site, m, mode, path, dataflow, shards, budget)
        assert torch.equal(matches, want_m), what
        assert sa.differing_lanes(sa.written_lanes(got),
                                  sa.written_lanes(want)) == [], what


@pytest.mark.gpu
def test_site_account_in_a_captured_graph_on_card(card):
    """Captured in a CUDA graph, the bookkeeping updates the same tensors in
    place as an eager call (bitwise, a ragged call reading its budget lane,
    written between the capture and the replay), and the capture's launch
    is counted once per replay."""
    from repro_torch.kernels import site_account as sa

    x, entry = _account_inputs(card, 8, 25600, 5120, seed=3)
    cur_q, _, mask = ops.delta_quant_fused(
        x, entry["prev_q"], entry["scale"], block_m=8, block_k=256,
        delta_dtype=BF16, impl="cuda")
    lane = torch.tensor(100, dtype=torch.int32, device=card)
    kw = dict(path="ragged", dataflow="output", block_m=8, block_k=256,
              n=5120, gn=40, w_itemsize=2, ema_decay=0.9, budget=lane)
    eager, graph = sa.copy_lanes(entry), sa.copy_lanes(entry)
    ptrs = {k: t.data_ptr() for k, t in sa.written_lanes(graph).items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, on copies
        sa.site_account(cur_q, mask, sa.copy_lanes(entry), **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = backend.launch_counts()
    g = torch.cuda.CUDAGraph()
    with backend.recorded_launches() as rec, torch.cuda.graph(g):
        sa.site_account(cur_q, mask, graph, **kw)
    assert backend.launch_counts() == before and rec["site_account"] == 1
    lane.fill_(1)  # a budget move: the replay reads the live lane
    g.replay()
    backend.count_replay(rec)
    sa.site_account(cur_q, mask, eager, **kw)
    torch.cuda.synchronize()
    assert backend.launch_counts()["site_account"] == \
        before["site_account"] + 2
    assert int(graph["sensor"]["overflow_fallbacks"]) == \
        int(entry["sensor"]["overflow_fallbacks"]) + 1
    assert {k: t.data_ptr() for k, t in sa.written_lanes(graph).items()} \
        == ptrs
    assert sa.differing_lanes(sa.written_lanes(graph),
                              sa.written_lanes(eager)) == []


# the fused entry's shapes: every site shape above, qwen2-72b's mlp_out
# (K 29568 = 115.5 tiles of 256) and a K the vector instance cannot take
FUSED_SHAPES = {**ACCOUNT_SHAPES, "qwen2_mlp_out": (29568, 8192),
                "k_tail_scalar": (3004, 4096)}


def _fused_kw(variant, n, card):
    from repro_torch.sensor.counters import ShardCtx

    _, path, dataflow, shards, budget = variant
    nl = n // shards if shards else n
    return dict(
        path=path, dataflow=dataflow, block_m=8, block_k=256,
        delta_dtype=BF16, n=nl, gn=-(-nl // 128), w_itemsize=2,
        ema_decay=0.9,
        budget=None if budget is None else torch.tensor(
            budget, dtype=torch.int32, device=card),
        shard=(ShardCtx(shards - 1, shards, n, -(-n // 128))
               if shards else None))


def _fused_equal(got, want, cache_got, cache_want, what):
    """delta, mask and matches equal, and every lane (prev_q among them)
    bitwise, NaN positions included."""
    from repro_torch.kernels import site_account as sa

    for a, b, part in zip(got, want, ("delta", "mask", "matches")):
        assert a.shape == b.shape and torch.equal(a, b), (what, part)
    assert sa.differing_lanes(sa.written_lanes(cache_got),
                              sa.written_lanes(cache_want)) == [], what


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 8, 128])
@pytest.mark.parametrize("site", list(FUSED_SHAPES))
def test_delta_quant_account_matches_plain_on_card(card, site, m):
    """The reuse-mode call's fused pass against its plain version
    (`delta_quant_torch` on padded operands, then `site_account_torch`), on
    copies of the same lanes: delta, the mask, the match counts, prev_q and
    every lane bitwise (NaN positions), at every site shape and batch (2:
    rows past M in the tile), over every reuse-mode variant; one launch a
    call and nothing else; prev_q and the lanes written in the entry's own
    tensors."""
    from repro_torch.kernels import site_account as sa

    k, n = FUSED_SHAPES[site]
    x, base = _account_inputs(card, m, k, n, seed=m + k + 1)
    for i, variant in enumerate(v for v in ACCOUNT_VARIANTS
                                if v[0] == "reuse"):
        # x and delta: bf16 and bf16 (the serve's), f32 and f32, bf16 and f32
        x_dtype, d_dtype = ((BF16, BF16), (F32, F32), (BF16, F32))[i % 3]
        got = sa.copy_lanes(base)
        if i % 3 == 0:
            for j, t in enumerate(sa.written_lanes(got).values()):
                if t.is_floating_point() and t.dim() == 0:
                    t.fill_((math.nan, math.inf, -math.inf)[j % 3])
        want = sa.copy_lanes(got)
        ptrs = {name: t.data_ptr() for name, t in
                sa.written_lanes(got).items()}
        kw = dict(_fused_kw(variant, n, card), delta_dtype=d_dtype)
        before = backend.launch_counts()
        out = sa.delta_quant_account(x.to(x_dtype), got, **kw)
        ref = sa.delta_quant_account_torch(x.to(x_dtype), want, **kw)
        torch.cuda.synchronize()
        after = backend.launch_counts()
        assert after == dict(before, delta_quant_account=before[
            "delta_quant_account"] + 1)
        _fused_equal(out, ref, got, want, (site, m, variant))
        assert {name: t.data_ptr() for name, t in
                sa.written_lanes(got).items()} == ptrs


@pytest.mark.gpu
def test_account_kernels_replayed_in_a_graph_on_card(card):
    """One CUDA graph holding a fused reuse-mode call (ragged, a budget
    lane) and a basic-mode site_account call, replayed 60 times with new
    codes written into its inputs between replays (and a budget move):
    after every replay each lane equals the plain versions' run on copies,
    so each launch's last CTA found itself and left the ticket at zero.
    Each kernel is one launch, counted once per replay."""
    from repro_torch.kernels import site_account as sa

    x, entry = _account_inputs(card, 8, 25600, 5120, seed=11)
    x2, entry_b = _account_inputs(card, 8, 4096, 4096, seed=12)
    xs = [x.to(BF16), (x * 1.5).to(BF16), x.to(BF16) * 0]
    codes = [torch.randint(-127, 128, (8, 4096), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(i)).to(torch.int8) for i in range(3)]
    lane = torch.tensor(100, dtype=torch.int32, device=card)
    kw = _fused_kw(("reuse", "ragged", "output", 0, None), 5120, card)
    kw["budget"] = lane
    kwb = dict(path="kernel", dataflow="output", block_m=8, block_k=256,
               n=4096, gn=32, w_itemsize=2, ema_decay=0.9, budget=None)
    x_in, q_in = xs[0].clone(), codes[0].clone()
    graph, graph_b = sa.copy_lanes(entry), sa.copy_lanes(entry_b)
    want, want_b = sa.copy_lanes(graph), sa.copy_lanes(graph_b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, on copies
        sa.delta_quant_account(x_in, sa.copy_lanes(entry), **kw)
        sa.site_account(q_in, None, sa.copy_lanes(entry_b), **kwb)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = backend.launch_counts()
    g = torch.cuda.CUDAGraph()
    with backend.recorded_launches() as rec, torch.cuda.graph(g):
        out = sa.delta_quant_account(x_in, graph, **kw)
        m_b = sa.site_account(q_in, None, graph_b, **kwb)
    assert backend.launch_counts() == before
    assert dict(rec) == {"delta_quant_account": 1, "site_account": 1}
    for r in range(60):
        x_in.copy_(xs[r % 3])
        q_in.copy_(codes[r % 3])
        lane.fill_(1 if r % 4 == 0 else 100)
        g.replay()
        backend.count_replay(rec)
        ref = sa.delta_quant_account_torch(x_in, want, **kw)
        ref_b = sa.site_account_torch(q_in, None, want_b, **kwb)
        torch.cuda.synchronize()
        _fused_equal(out, ref, graph, want, ("replay", r))
        assert torch.equal(m_b, ref_b), r
        assert sa.differing_lanes(sa.written_lanes(graph_b),
                                  sa.written_lanes(want_b)) == [], r
    after = backend.launch_counts()
    assert after["delta_quant_account"] == \
        before["delta_quant_account"] + 60
    assert after["site_account"] == before["site_account"] + 60
    assert int(graph["steps"]) == int(entry["steps"]) + 60


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dk", [(8, 64, 64), (2, 4, 32)])
def test_wkv6_decode_matches_plain_on_card(card, b, h, dk):
    """S' bitwise (the kernel rounds w·S and + kv apart, as the plain
    version's two kernels do); out within atol 1e-5 + rtol 1e-5 of the sum
    of |terms| (a dk-term f32 sum in another order)."""
    gen = torch.Generator(device=card).manual_seed(0)
    r, k, v, u = (torch.randn(shape, generator=gen, device=card)
                  for shape in ((b, h, dk),) * 3 + ((h, dk),))
    w = torch.rand((b, h, dk), generator=gen, device=card) * 0.9 + 0.05
    state = torch.randn((b, h, dk, dk), generator=gen, device=card)
    want_o, want_s = wkv6_decode_torch(r, k, v, w, u, state)
    terms = (r[..., :, None] * (u[None, :, :, None] * k[..., :, None]
                                * v[..., None, :] + state)).abs().sum(-2)
    before = backend.launch_counts()["wkv6_decode"]
    out, same = wkv6_decode(r, k, v, w, u, state)
    torch.cuda.synchronize()
    assert backend.launch_counts()["wkv6_decode"] == before + 1
    assert same is state and torch.equal(state, want_s)
    assert bool(((out - want_o).abs() <= 1e-5 + 1e-5 * terms).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dk", [(8, 64, 64), (2, 4, 32), (3, 5, 128)])
def test_wkv6_decode_backward_matches_plain_on_card(card, b, h, dk):
    """The step's gradient: S̄ (written over ∂L/∂S' in place) bitwise; r̄,
    k̄, v̄, w̄ and ū within atol 1e-5 + rtol 1e-5 of the sum of |terms| (the
    plain backward of the absolute values bounds it): dk- or dv-term f32
    sums in another order. One launch counted."""
    from repro_torch.kernels.wkv6_decode import (
        wkv6_decode_backward,
        wkv6_decode_backward_torch,
    )

    gen = torch.Generator(device=card).manual_seed(1)
    r, k, v, g_out = (torch.randn((b, h, dk), generator=gen, device=card)
                      for _ in range(4))
    u = torch.randn((h, dk), generator=gen, device=card)
    w = torch.rand((b, h, dk), generator=gen, device=card) * 0.9 + 0.05
    state, g_state = (torch.randn((b, h, dk, dk), generator=gen, device=card)
                      for _ in range(2))
    g0 = g_state.clone()
    *want, want_s = wkv6_decode_backward_torch(r, k, v, w, u, state, g_out,
                                               g0)
    terms = wkv6_decode_backward_torch(r.abs(), k.abs(), v.abs(), w, u.abs(),
                                       state.abs(), g_out.abs(), g0.abs())[:5]
    before = backend.launch_counts()["wkv6_decode_backward"]
    got = wkv6_decode_backward(r, k, v, w, u, state, g_out, g_state)
    torch.cuda.synchronize()
    assert backend.launch_counts()["wkv6_decode_backward"] == before + 1
    assert torch.equal(g_state, want_s)
    for name, a, e, sc in zip("rkvwu", got, want, terms):
        assert bool(((a - e).abs() <= 1e-5 + 1e-5 * sc).all()), name


@pytest.mark.gpu
def test_wkv6_decode_state_out_keeps_the_in_place_step(card):
    """The forward with a separate output state writes S' there, bitwise
    the in-place step's, leaves the input state as it was, and gives the
    same out bitwise; WKV6Sequence's gradients on the card match autograd
    through the plain steps."""
    from repro_torch.kernels.wkv6_decode import WKV6Sequence

    gen = torch.Generator(device=card).manual_seed(2)
    b, h, dk = 8, 64, 64
    r, k, v, u = (torch.randn(shape, generator=gen, device=card)
                  for shape in ((b, h, dk),) * 3 + ((h, dk),))
    w = torch.rand((b, h, dk), generator=gen, device=card) * 0.9 + 0.05
    state = torch.randn((b, h, dk, dk), generator=gen, device=card)
    keep, out_state = state.clone(), torch.empty_like(state)
    o1, s1 = wkv6_decode(r, k, v, w, u, state, out_state)
    assert s1 is out_state and torch.equal(state, keep)
    o2, s2 = wkv6_decode(r, k, v, w, u, state)
    assert s2 is state and torch.equal(o1, o2) and torch.equal(s1, s2)

    s_len = 6
    ins = [torch.randn((b, s_len, h, dk), generator=gen, device=card)
           for _ in range(3)]
    ins += [torch.rand((b, s_len, h, dk), generator=gen, device=card) * 0.9
            + 0.05, u, keep]
    g_out = torch.randn((b, s_len, h, dk), generator=gen, device=card)
    ka = [x.clone().requires_grad_(True) for x in ins]
    out, _ = WKV6Sequence.apply(*ka)
    got = torch.autograd.grad((out * g_out).sum(), ka)
    pa = [x.clone().requires_grad_(True) for x in ins]
    st, outs = pa[5], []
    for t in range(s_len):
        o, st = wkv6_decode_torch(*(x[:, t] for x in pa[:4]), pa[4], st)
        outs.append(o)
    want = torch.autograd.grad((torch.stack(outs, 1) * g_out).sum(), pa)
    for g, e in zip(got, want):
        assert float((g - e).abs().max()) <= 1e-4 * float(e.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m,bm,k,n,case", [
    (8, 8, 1024, 384, "split"), (16, 8, 1024, 384, "split"),
    (16, 16, 1024, 384, "split"), (128, 128, 1024, 384, "split"),
    (256, 128, 1024, 384, "split"), (8, 8, 256, 128, "split"),
    (128, 128, 256, 128, "split"), (8, 8, 4096, 384, "masked"),
    (128, 128, 4096, 384, "masked"), (8, 8, 1024, 256, "extreme"),
    (128, 128, 4096, 256, "extreme")])
def test_int8_split_matches_plain_on_card(card, m, bm, k, n, case):
    """The int8 GEMM on the card, bitwise equal to its plain version and to
    the exact product, one launch per call. "split": lo then hi of a
    delta_encode_int8 split whose second k tile (the only one at k = 256)
    changed and whose |Δ| = 254 at four codes overflows; "masked": no code
    changed (skip 1.0), so both calls pass prev_acc through; "extreme":
    every Δ and weight code at ±127, so |Σ| = 127²·k everywhere. The CTA
    tiles (8 rows through `mma.sync`, 128 rows through `wgmma`; 64 and 128
    columns) meet here at several rows per mask group: n = 128 is one
    128-column tile, k = 256 one k tile."""
    gen = torch.Generator(device=card).manual_seed(0)
    bk = 256
    wq = torch.randint(-127, 128, (k, n), generator=gen,
                       device=card).to(torch.int8)
    acc = torch.randint(-1000, 1000, (m, n), generator=gen, device=card,
                        dtype=torch.int32)
    before = backend.launch_counts()["reuse_matmul_int8"]
    if case == "extreme":
        sign_m = torch.arange(m, device=card) % 2 * 2 - 1
        sign_n = torch.arange(n, device=card) % 3 % 2 * 2 - 1
        d = (127 * sign_m[:, None]).expand(m, k).to(torch.int8).contiguous()
        wq = (127 * sign_n[None, :]).expand(k, n).to(torch.int8).contiguous()
        mask = torch.ones((m // bm, k // bk), dtype=torch.int32, device=card)
        out = ops.reuse_matmul_int8(d, wq, acc, mask, block_m=bm, block_k=bk)
        torch.cuda.synchronize()
        assert backend.launch_counts()["reuse_matmul_int8"] == before + 1
        assert torch.equal(out, reuse_matmul_int8_torch(
            d, wq, acc, mask, block_m=bm, block_k=bk))
        exact = acc.double() + d.double() @ wq.double()
        assert torch.equal(out, exact.to(torch.int32))
        assert bool(((out - acc).abs() == 127 ** 2 * k).all())
        return
    prev = torch.randint(-127, 128, (m, k), generator=gen, device=card)
    cur = prev.clone()
    if case == "split":
        j = bk if k > bk else 0
        cur[:, j:j + bk] = torch.randint(-127, 128, (m, bk), generator=gen,
                                         device=card)
        cur[0, :4], prev[0, :4] = 127, -127   # |Δ| = 254: the split overflows
    cur, prev = cur.to(torch.int8), prev.to(torch.int8)
    enc = delta_encode_int8(cur, prev, block_m=bm, block_k=bk)
    assert bool(enc.has_overflow) == (case == "split")
    lo = ops.reuse_matmul_int8(enc.lo, wq, acc, enc.lo_mask, block_m=bm,
                               block_k=bk)
    out = ops.reuse_matmul_int8(enc.hi, wq, lo, enc.hi_mask, block_m=bm,
                                block_k=bk)
    torch.cuda.synchronize()
    assert backend.launch_counts()["reuse_matmul_int8"] == before + 2
    want = reuse_matmul_int8_torch(enc.lo, wq, acc, enc.lo_mask, block_m=bm,
                                   block_k=bk)
    assert torch.equal(lo, want)
    assert torch.equal(out, reuse_matmul_int8_torch(
        enc.hi, wq, want, enc.hi_mask, block_m=bm, block_k=bk))
    exact = acc.double() + (cur.double() - prev.double()) @ wq.double()
    assert torch.equal(out, exact.to(torch.int32))
    if case == "masked":
        assert not bool(enc.lo_mask.any()) and torch.equal(out, acc)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernels", [
    ("qwen3-32b", ("delta_quant_account", "reuse_matmul_output")),
    ("rwkv6-7b", ("delta_quant_account", "reuse_matmul_output",
                  "wkv6_decode")),
    ("mixtral-8x7b", ("delta_quant_account", "reuse_matmul_output")),
    ("llama4-scout-17b-a16e", ("delta_quant_account", "reuse_matmul_output")),
    ("zamba2-2.7b", ("delta_quant_account", "reuse_matmul_output")),
    ("gemma3-12b", ("delta_quant_account", "reuse_matmul_output")),
    ("qwen2-72b", ("delta_quant_account", "reuse_matmul_output")),
    ("nemotron-4-15b", ("delta_quant_account", "reuse_matmul_output")),
    ("qwen2-vl-7b", ("delta_quant_account", "reuse_matmul_output"))])
def test_serve_runs_the_kernels_on_the_card(card, capsys, arch, kernels):
    """Every reuse-mode site call runs the fused delta_quant_account (its
    bookkeeping included), a basic-mode call site_account after its
    product; the unfused delta_quant is not on the serve path."""
    backend.reset_launches()
    tserve_cli.main(["--arch", arch, "--reduced", "--requests", "2",
                     "--batch-slots", "2", "--prompt-len", "4",
                     "--cache-len", "16", "--max-new", "3", "--reuse"])
    counts = backend.launch_counts()
    assert all(counts[kn] > 0 for kn in kernels), counts
    assert counts["delta_quant_account"] > 0, counts
    assert counts["delta_quant"] == 0, counts
    assert "served 2/2 requests" in capsys.readouterr().out


# ------------------------------------------------ CUDA graphs of the serve step

def _graph_kernel_call(kernel, card):
    """(call, state): a zero-argument call of one serve-path kernel at a
    serve shape on fixed inputs, and the tensor it updates in place (or
    None). The cluster launches (delta_quant at block_m 128, the float ΔW
    GEMMs at C > 1) go through cudaLaunchKernelEx."""
    gen = torch.Generator(device=card).manual_seed(5)
    if kernel == "wkv6_decode":
        r, k, v, u = (torch.randn(s, generator=gen, device=card)
                      for s in ((8, 64, 64),) * 3 + ((64, 64),))
        w = torch.rand((8, 64, 64), generator=gen, device=card) * 0.9 + 0.05
        state = torch.randn((8, 64, 64, 64), generator=gen, device=card)
        return (lambda s: wkv6_decode(r, k, v, w, u, s)[0]), state
    if kernel.startswith("delta_quant"):
        m, bm = (128, 128) if kernel.endswith("128") else (8, 8)
        x = torch.randn((m, 25600), generator=gen, device=card).to(BF16)
        prev_q = torch.randint(-127, 128, (m, 25600), generator=gen,
                               device=card).to(torch.int8)
        scale = torch.tensor(0.05, device=card)
        return (lambda s: delta_quant(x, prev_q, scale, block_m=bm,
                                      block_k=256)), None
    k, n = {"output": (5120, 10240), "ragged": (5120, 10240),
            "input": (25600, 5120)}[kernel]
    mask = input_mask(0.5, 1, k // 256, gen, card)
    em = mask.repeat_interleave(8, 0).repeat_interleave(256, 1)
    delta = (torch.randn((8, k), generator=gen, device=card) * em).to(BF16)
    w = (torch.randn((k, n), generator=gen, device=card) / 64).to(BF16)
    prev = torch.randn((8, n), generator=gen, device=card)
    if kernel == "ragged":
        idx, counts = compact_rows(mask)
        return (lambda s: reuse_matmul_ragged(
            delta, w, prev, counts, idx, block_m=8, block_n=128,
            block_k=256)), None
    return (lambda s: reuse_matmul(delta, w, prev, mask, block_m=8,
                                   block_n=128, block_k=256,
                                   dataflow=kernel)), None


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["delta_quant", "delta_quant_128",
                                    "output", "input", "ragged",
                                    "wkv6_decode"])
def test_kernel_in_a_captured_graph_matches_eager_on_card(card, kernel):
    """Launched inside a captured CUDA graph, each serve-path kernel gives
    bitwise its eager launch's results (in-place state included), and the
    capture's launch is counted once per replay, not at capture."""
    call, state = _graph_kernel_call(kernel, card)
    s_eager = None if state is None else state.clone()
    s_graph = None if state is None else state.clone()
    want = call(s_eager)        # eager, and the warm-up of the capture
    torch.cuda.synchronize()
    before = backend.launch_counts()
    g = torch.cuda.CUDAGraph()
    with backend.recorded_launches() as rec, torch.cuda.graph(g):
        got = call(s_graph)
    assert backend.launch_counts() == before and sum(rec.values()) == 1
    g.replay()
    backend.count_replay(rec)
    torch.cuda.synchronize()
    assert sum(backend.launch_counts().values()) == sum(before.values()) + 1
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)
    if state is not None:
        assert torch.equal(s_eager, s_graph)


def _reduced_step(arch, card, graphs, variant="default"):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    policy = ReusePolicy()
    if variant in ("ragged", "compact"):
        policy = ReusePolicy(site_tunables={
            s: SiteTunables(exec_path=variant, max_active_k=1)
            for s in ("attn_qkv", "mlp_in", "rwkv_wr", "rwkv_cmix_wk")})
    engine = build_reuse_engine(cfg, block_k=64, policy=policy)
    return CompiledStep(init_params(cfg, 0, device=card), cfg,
                        init_serve_state(cfg, 2, 32, device=card), batch=2,
                        engine=engine, rcache=engine.init_cache(2, device=card),
                        graphs=graphs)


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# the site whose layer-0 lane the graph test flips, where not attn_out
FLIP_SITE = {"rwkv6-7b": "rwkv_wo", "zamba2-2.7b": "shared_attn_out",
             "gemma3-12b": "attn_global_out"}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b", "mixtral-8x7b",
                                  "llama4-scout-17b-a16e", "zamba2-2.7b",
                                  "gemma3-12b", "qwen2-72b", "nemotron-4-15b",
                                  "qwen2-vl-7b"])
def test_graph_step_matches_eager_step_on_card(card, arch):
    """Reduced bf16 models: the same prefills and decode steps, eagerly and
    through captured graphs (with a mode flip and a flip back between
    steps, so one variant is captured and one replayed after a flip), give
    bitwise the same logits, state, reuse cache and launch counts."""
    runs = []
    for graphs in (False, True):
        backend.reset_launches()
        step = _reduced_step(arch, card, graphs)
        site = FLIP_SITE.get(arch, "attn_out")
        gen = torch.Generator(device=card).manual_seed(0)
        logits = [step.prefill(torch.randint(
            0, step.cfg.vocab, (2, 8), generator=gen, device=card)).clone()]
        tok = logits[0][:, -1:].argmax(-1).to(torch.int32)
        for i in range(6):
            if i in (2, 4):
                step.engine.set_mode(step.rcache, site,
                                     "basic" if i == 2 else "reuse", layer=0)
            logits.append(step.decode(tok).clone())
            tok = logits[-1].argmax(-1).to(torch.int32)
        logits.append(step.prefill(torch.randint(
            0, step.cfg.vocab, (2, 8), generator=gen, device=card)).clone())
        torch.cuda.synchronize()
        runs.append((logits, _tensor_leaves(step.state),
                     _tensor_leaves(step.rcache), backend.launch_counts(),
                     step.summary()))
    (le, se, re, ce, _), (lg, sg, rg, cg, summ) = runs
    assert summ["captures"] == 3 and summ["decode"] == 2
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert all(torch.equal(a, b) for a, b in zip(se + re, sg + rg))
    assert ce == cg and ce["delta_quant_account"] > 0
    backend.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b", "mixtral-8x7b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("variant", ["default", "ragged", "compact",
                                     "basic"])
def test_eager_decode_step_syncs_nothing_on_card(card, arch, variant):
    """Under torch.cuda.set_sync_debug_mode("error") an eager decode step
    raises on any call that waits for the card: there must be none."""
    step = _reduced_step(arch, card, graphs=False,
                         variant=variant if variant != "basic" else
                         "default")
    step.prefill(torch.ones((2, 8), dtype=torch.int32, device=card))
    step.decode(torch.ones((2, 1), dtype=torch.int32, device=card))
    if variant == "basic":
        for name in step.engine.sites:
            step.engine.set_mode(step.rcache, name, "basic")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            step.run_decode()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_compact_budget_move_captures_nothing_on_card(card):
    """A budget move on a compact site reaches its accounting through the
    budget lane: the next decode replays the graph it had, and the replay
    is bitwise the eager step under the same budgets."""
    runs = []
    for graphs in (False, True):
        step = _reduced_step("qwen3-32b", card, graphs, variant="compact")
        step.prefill(torch.ones((2, 8), dtype=torch.int32, device=card))
        logits = []
        for i in range(4):
            if i == 2:
                assert step.engine.set_budget("attn_qkv", 2)
            tok = torch.full((2, 1), 3 + (i % 2), dtype=torch.int32,
                             device=card)
            logits.append(step.decode(tok).clone())
        torch.cuda.synchronize()
        runs.append((logits, _tensor_leaves(step.rcache), step.summary()))
    (le, re, _), (lg, rg, summ) = runs
    assert summ["decode"] == 1 and summ["captures"] == 2
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert all(torch.equal(a, b) for a, b in zip(re, rg))


@pytest.mark.gpu
def test_expert_reuse_matches_dense_top1_on_card(card):
    """Per-(slot, expert) reuse at bf16 weights on the card against the
    quantized dense top-1 product computed with widened weights, in f32
    before the final bf16 cast: the wi lane against the dense hi, and the
    output from the lane's own activation codes against the dense product
    of those codes, within the f32 GEMM tolerance (atol 1e-4, rtol 1e-5);
    the activation codes equal the dense ones but for codes at a rounding
    boundary (at most 1e-3 of them)."""
    from repro_torch.core import expert_reuse as er
    from repro_torch.models.layers import apply_norm
    from repro_torch.quant import dequantize_int8, quantize_int8

    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), top_k=1,
                              param_dtype="bfloat16")
    p = {k: (v[0] if isinstance(v, torch.Tensor) else {"scale": v["scale"][0]})
         for k, v in init_params(cfg, 0, device=card)["blocks"]["moe"].items()}
    b = 4
    cache = er.layer_slice(er.init_expert_reuse_cache(cfg, b, device=card), 0)
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=card)
    ar = torch.arange(b, device=card)
    flips = 0
    for step in range(6):
        x = x + 0.3 * torch.randn(x.shape, generator=gen, device=card)
        xb = x.to(BF16)
        out, cache, stats = er.moe_reuse_forward(p, cfg, xb, cache,
                                                 block_k=32)
        h = apply_norm(p["norm"], xb, cfg.norm_eps).reshape(b, -1)
        logits = h.float() @ p["router"]
        top_e = logits.argmax(-1)
        gate = torch.softmax(logits, -1)[ar, top_e]
        s, sa = cache["scale"], cache["act_scale"]
        hq = dequantize_int8(quantize_int8(h, s), s)
        hi = torch.einsum("bd,bdf->bf", hq, p["wi"][top_e].float())
        torch.testing.assert_close(cache["prev_hi"][top_e, ar], hi,
                                   rtol=1e-5, atol=1e-4)
        g, u = torch.chunk(hi, 2, dim=-1)
        act_q = quantize_int8(torch.nn.functional.silu(g) * u, sa)
        lane_act = cache["prev_act_q"][top_e, ar]
        flips += int((lane_act != act_q).sum())
        want = torch.einsum("bf,bfd->bd", dequantize_int8(lane_act, sa),
                            p["wo"][top_e].float()) * gate[:, None]
        got = cache["prev_out"][top_e, ar] * gate[:, None]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert torch.equal(out.reshape(b, -1), got.to(BF16))
    assert flips <= 1e-3 * 6 * b * cfg.d_ff


@pytest.mark.gpu
def test_failed_capture_raises_on_card(card, monkeypatch):
    """A step that cannot be captured (here it waits for the card) raises;
    it never gives way to the eager step."""
    step = _reduced_step("qwen3-32b", card, graphs=True)
    orig = step.run_decode

    def waits():
        out = orig()
        torch.cuda.synchronize()
        return out
    monkeypatch.setattr(step, "run_decode", waits)
    step.prefill(torch.ones((2, 8), dtype=torch.int32, device=card))
    with pytest.raises(RuntimeError, match="capture of the decode step"):
        step.decode(torch.ones((2, 1), dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert step.captures == 1 and step.decode_key() not in step.variants


# ------------------------------- measured decode, the sweep and the tuning loop

def _measured(card, arch, graphs, policy=None, steps=6):
    """A reduced bf16 model's measured decode on the correlated stream: the
    report rows, launch counts, final reuse cache and decode state, and the
    run."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    backend.reset_launches()
    md = run_measured_decode(arch, steps=steps, batch=2, correlation=0.95,
                             device=card, cfg=cfg, policy=policy,
                             graphs=graphs)
    torch.cuda.synchronize()
    return (md.report.to_dicts(), backend.launch_counts(),
            _tensor_leaves(md.cache) + _tensor_leaves(md.step.state), md)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_measured_decode_graphs_match_eager_on_card(card, arch):
    """The runner through CUDA graphs is bitwise its eager run: JSONL rows,
    launch counts, the final reuse cache and decode state; one decode
    variant is captured and replayed for the rest of the stream."""
    rows_e, counts_e, tensors_e, _ = _measured(card, arch, graphs=False)
    rows_g, counts_g, tensors_g, md = _measured(card, arch, graphs=True)
    assert rows_e == rows_g and counts_e == counts_g
    assert all(torch.equal(a, b) for a, b in zip(tensors_e, tensors_g))
    assert counts_g["delta_quant_account"] > 0 and \
        counts_g["reuse_matmul_output"] > 0
    assert md.step.graphs and md.step.captures == 1
    if arch == "qwen3-32b":  # layer 0's attn_qkv sees the anchor again
        assert md.report.per_layer[0].skipped_tiles > 0
    backend.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [0.0, 0.25, 0.5, 0.75, 0.9])
@pytest.mark.parametrize("dataflow", ["output", "input"])
def test_sweep_kernels_match_plain_on_card(card, skip, dataflow):
    """The skip sweep's calls: the masked kernel and the ragged kernel (its
    live counts within `ReusePolicy.ragged_budget`) against their plain
    versions at each swept skip, bf16, M = 8."""
    gen = torch.Generator(device=card).manual_seed(int(skip * 100))
    m, k, n = 8, 2048, 512
    gk = k // 256
    mask = input_mask(skip, 1, gk, gen, card)
    em = mask.repeat_interleave(8, 0).repeat_interleave(256, 1)
    delta = (torch.randn((m, k), generator=gen, device=card) * em).to(BF16)
    w = (torch.randn((k, n), generator=gen, device=card) / 45).to(BF16)
    prev = torch.randn((m, n), generator=gen, device=card)
    idx, counts = compact_rows(mask)
    budget = ReusePolicy.ragged_budget(gk, skip)
    assert int(ops.budget_overflow(counts, gk=gk, max_active_k=budget)) == 0
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=8, block_k=256)
    got = reuse_matmul(delta, w, prev, mask, block_m=8, block_n=128,
                       block_k=256, dataflow=dataflow)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    plain = reuse_matmul_ragged_torch(delta, w, prev, counts, idx, block_m=8,
                                      block_n=128, block_k=256)
    got = reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=8,
                              block_n=128, block_k=256)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("block_k", [64, 128, 256, 512])
def test_fitted_block_k_choices_on_card(card, block_k):
    """Every block_k the fitter may pick (`BLOCK_K_CHOICES`) at a serve
    width: delta_quant bitwise, the masked and ragged kernels within the
    bf16 GEMM tolerance."""
    gen = torch.Generator(device=card).manual_seed(block_k)
    m, k, n = 8, 5120, 1024
    x = torch.randn((m, k), generator=gen, device=card).to(BF16)
    prev_q = torch.randint(-127, 128, (m, k), generator=gen,
                           device=card).to(torch.int8)
    scale = torch.tensor(0.05, device=card)
    got = delta_quant(x, prev_q, scale, block_m=8, block_k=block_k)
    want = delta_quant_torch(x, prev_q, scale, block_m=8, block_k=block_k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mask = input_mask(0.5, 1, k // block_k, gen, card)
    em = mask.repeat_interleave(8, 0).repeat_interleave(block_k, 1)
    delta = (torch.randn((m, k), generator=gen, device=card) * em).to(BF16)
    w = (torch.randn((k, n), generator=gen, device=card) / 70).to(BF16)
    prev = torch.randn((m, n), generator=gen, device=card)
    want = reuse_matmul_torch(delta, w, prev, mask, block_m=8,
                              block_k=block_k)
    for dataflow in ("output", "input"):
        got = reuse_matmul(delta, w, prev, mask, block_m=8, block_n=128,
                           block_k=block_k, dataflow=dataflow)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    idx, counts = compact_rows(mask)
    got = reuse_matmul_ragged(delta, w, prev, counts, idx, block_m=8,
                              block_n=128, block_k=block_k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_fitted_ragged_table_captures_and_replays_on_card(card, tmp_path):
    """Record → fit → exploit on the card: a table fitted for the kernel
    tier with a gate of 0 promotes sites to ragged; the exploit run's decode
    key carries the promoted specs, is captured once and replayed for the
    rest of the stream, launches the ragged kernel, and is bitwise its
    eager run."""
    *_, record = _measured(card, "qwen3-32b", graphs=True)
    trace = str(tmp_path / "trace.jsonl")
    record.report.write_jsonl(trace)
    tunables = fit_trace(load_trace(trace),
                         FitConfig(pallas_target=True, ragged_min_skip=0.0))
    promoted = [n for n, t in tunables.items() if t.exec_path == "ragged"]
    assert promoted
    table = str(tmp_path / "tuned.json")
    save_table(table, tunables)
    rows_e, counts_e, tensors_e, _ = _measured(
        card, "qwen3-32b", graphs=False, policy=load_tuned_policy(table))
    rows_g, counts_g, tensors_g, md = _measured(
        card, "qwen3-32b", graphs=True, policy=load_tuned_policy(table))
    assert rows_e == rows_g and counts_e == counts_g
    assert all(torch.equal(a, b) for a, b in zip(tensors_e, tensors_g))
    assert counts_g["reuse_matmul_ragged"] > 0
    (key,) = [k for k in md.step.variants if k[0] == "decode"]
    specs = dict(key[1])
    assert all(specs[n].exec_path == "ragged" for n in promoted)
    assert md.step.captures == 1 and md.steps > md.step.captures
    assert {r["site"]: r["exec_path"] for r in rows_g
            if r["kind"] == "site"}.items() >= {n: "ragged"
                                                for n in promoted}.items()
    backend.reset_launches()


# ------------------------------------------------------ the online control plane

def _controlled(card, arch, graphs, monkeypatch, n_layers=None, profile_at=0,
                guard=False):
    """A reduced bf16 model's measured decode on the reference's acceptance
    stream for the control plane (batch 2, correlation 1.0, 26 steps, a
    burst at 19-22) with the Controller every 2 steps (with `guard`, a
    QuarantineBreaker attached). Returns (journal rows without `ts`, greedy
    tokens, launch counts, tensors, the run, the controller, the profiled
    interval's device→host copies)."""
    from repro_torch.sensor import runner

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ctl = Controller(ControlConfig(min_window_steps=2),
                     guard=QuarantineBreaker() if guard else None)
    tokens, dtoh = [], {}
    greedy = runner.greedy_sample
    monkeypatch.setattr(runner, "greedy_sample",
                        lambda logits: tokens.append(greedy(logits))
                        or tokens[-1])

    def on_step(i, engine, cache):
        if i % 2:
            return
        if i != profile_at:
            ctl.step(engine, cache, step=i)
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = ctl.step(engine, cache, step=i)
            torch.cuda.synchronize()
        dtoh["copies"] = sum(1 for e in prof.events()
                             if "Memcpy DtoH" in e.name)
        dtoh["windows"] = len(rep.window_steps)

    backend.reset_launches()
    md = runner.run_measured_decode(
        arch, steps=26 if not profile_at else profile_at, batch=2,
        correlation=1.0, burst=(19, 22), on_step=on_step, device=card,
        cfg=cfg, graphs=graphs)
    torch.cuda.synchronize()
    rows = [{k: v for k, v in r.items() if k != "ts"}
            for rep in ctl.reports for r in rep.to_dicts()]
    return (rows, torch.cat(tokens).tolist(), backend.launch_counts(),
            _tensor_leaves(md.cache) + _tensor_leaves(md.step.state), md,
            ctl, dtoh)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b"])
def test_closed_loop_graphs_match_eager_on_card(card, arch, monkeypatch):
    """The controlled measured decode through CUDA graphs is bitwise its
    eager run: journal rows, tokens, launch counts, final reuse cache and
    decode state, specs; the controller's spec changes and mode flips
    captured new variants."""
    rows_e, tok_e, counts_e, tensors_e, md_e, _, _ = _controlled(
        card, arch, False, monkeypatch)
    rows_g, tok_g, counts_g, tensors_g, md_g, ctl, _ = _controlled(
        card, arch, True, monkeypatch)
    assert rows_e == rows_g and tok_e == tok_g and counts_e == counts_g
    assert all(torch.equal(a, b) for a, b in zip(tensors_e, tensors_g))
    assert md_e.engine.sites == md_g.engine.sites
    assert any(d.kind == "budget" for r in ctl.reports for d in r.decisions)
    assert md_g.step.captures > 1 and counts_g["delta_quant_account"] > 0
    backend.reset_launches()


@pytest.mark.gpu
def test_controller_interval_copies_to_host_once_per_read_on_card(
        card, monkeypatch):
    """One Controller.step with windows on every site: the device→host
    copies (torch.profiler's Memcpy DtoH) do not grow with the number of
    sites (qwen3 4, rwkv6 8) or layers (2, 4): the counters come in one
    packed transfer, the ctrl lanes in another."""
    seen = {}
    for arch, n_layers in (("qwen3-32b", 2), ("qwen3-32b", 4),
                           ("rwkv6-7b", 2)):
        *_, md, _, dtoh = _controlled(card, arch, False, monkeypatch,
                                      n_layers=n_layers, profile_at=4)
        assert dtoh["windows"] == len(md.engine.sites)
        seen[(arch, n_layers)] = dtoh["copies"]
    assert set(seen.values()) == {2}, seen
    backend.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_layers", [("qwen3-32b", 2), ("rwkv6-7b", 2)])
def test_guarded_interval_copies_one_more_on_card(card, monkeypatch, arch,
                                                  n_layers):
    """With the QuarantineBreaker attached, one Controller.step copies to
    the host exactly once more than without it (the breaker's snapshot,
    which carries the sentinel lanes in its one packed transfer)."""
    copies = {}
    for guard in (False, True):
        *_, md, _, dtoh = _controlled(card, arch, False, monkeypatch,
                                      n_layers=n_layers, profile_at=4,
                                      guard=guard)
        assert dtoh["windows"] == len(md.engine.sites)
        copies[guard] = dtoh["copies"]
    assert copies == {False: 2, True: 3}, copies
    backend.reset_launches()


def _guarded_serve_steps(card, graphs):
    """A reduced bf16 qwen3 CompiledStep with the guarded Controller every 2
    steps and a NaN poisoned into the last layer's mlp_out after step 3:
    logits per step, tensors, journal rows, launch counts and the step."""
    step = _reduced_step("qwen3-32b", card, graphs)
    ctl = Controller(ControlConfig(), guard=QuarantineBreaker())
    inj = FaultInjector("poison-nan", at_step=3, site="mlp_out",
                        layer=step.cfg.n_layers - 1)
    backend.reset_launches()
    gen = torch.Generator(device=card).manual_seed(0)
    logits = [step.prefill(torch.randint(
        0, step.cfg.vocab, (2, 8), generator=gen, device=card)).clone()]
    tok = logits[0][:, -1:].argmax(-1).to(torch.int32)
    for i in range(1, 9):
        logits.append(step.decode(tok).clone())
        tok = logits[-1].argmax(-1).to(torch.int32)
        inj.on_cache_update(step.rcache, i)
        if i % 2 == 0:
            ctl.step(step.engine, step.rcache, step=i)
    torch.cuda.synchronize()
    rows = [{k: v for k, v in r.items() if k != "ts"}
            for rep in ctl.reports for r in rep.to_dicts()]
    return (logits, _tensor_leaves(step.state) + _tensor_leaves(step.rcache),
            rows, backend.launch_counts(), step)


@pytest.mark.gpu
def test_guarded_graph_step_matches_eager_step_on_card(card):
    """The guarded decode through CUDA graphs equals its eager run bitwise:
    logits per step (the NaN step included), the final state and reuse
    cache, journal rows and launch counts; the quarantine of the poisoned
    lane captured a variant and the logits are finite after the trip."""
    le, te, re, ce, _ = _guarded_serve_steps(card, False)
    lg, tg, rg, cg, step = _guarded_serve_steps(card, True)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for a, b in zip(le, lg):
        assert torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
    assert all(torch.equal(a, b) for a, b in zip(te, tg))
    assert re == rg and ce == cg
    trips = [r for r in rg if r.get("decision_kind") == "quarantine"
             and r.get("after") == "quarantined"]
    assert [(r["step"], r["site"]) for r in trips] == [(4, "mlp_out")]
    assert not torch.isfinite(lg[4]).all()
    assert all(torch.isfinite(x).all() for x in lg[5:])
    assert step.captures >= 3
    backend.reset_launches()


@pytest.mark.gpu
def test_evicted_variant_returns_its_pool_on_card(card):
    """Past the cap of live decode variants, the least recently used one is
    evicted and its private pool goes back to the card: the reserved
    memory drops by at least that pool, and its key is captured again when
    it comes back."""
    step = _reduced_step("qwen3-32b", card, graphs=True)
    step.max_decode_variants = 1
    tok = torch.ones((2, 1), dtype=torch.int32, device=card)
    step.prefill(torch.ones((2, 8), dtype=torch.int32, device=card))
    step.decode(tok)
    key_a = step.decode_key()
    pool = step.variants[key_a].pool_bytes
    assert pool > 0
    step.engine.set_mode(step.rcache, "attn_out", "basic", layer=0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(card)
    step._make_room()
    after = torch.cuda.memory_reserved(card)
    assert key_a not in step.variants and step.evictions == 1
    assert before - after >= pool, (before, after, pool)
    step.decode(tok)                                   # captures key B
    step.engine.set_mode(step.rcache, "attn_out", "reuse", layer=0)
    step.decode(tok)                                   # key A again
    s = step.summary()
    assert (s["decode"], s["live_decode"], s["evictions"]) == (3, 1, 2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (8, 2048, 51200),
                                   (16, 4096, 4096)])
def test_basic_product_matches_widened_on_card(card, m, k, n):
    """The basic-mode product on the card, one bf16 product with an f32
    result, against the widened xq.float() @ w.float(): the same bf16
    products (exact in f32) summed in another order."""
    gen = torch.Generator(device=card).manual_seed(k)
    xq = torch.randn((m, k), generator=gen, device=card).to(BF16)
    w = (torch.randn((k, n), generator=gen, device=card)
         / math.sqrt(k)).to(BF16)
    out = ops.f32_product(xq, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, xq.float() @ w.float(), rtol=1e-4,
                               atol=1e-3)


# ------------------------------------------------- the observability plane

@pytest.mark.gpu
def test_span_sync_waits_for_the_device_on_card(card):
    """A span's `sync` synchronizes the device of the value it was given:
    the span covers a ~50 ms device sleep queued inside it, where the same
    span without the sync closes before the sleep ends."""
    from repro_torch.obs import trace

    trace.enable()
    try:
        x = torch.ones(1, device=card)
        for synced in (True, False):
            with trace.span("sleep", synced=synced) as sp:
                torch.cuda._sleep(50_000_000)  # cycles, about 25-50 ms
                y = x + 1
                if synced:
                    sp.sync(y)
            torch.cuda.synchronize()
        rows = {r["synced"]: r["dur_s"] for r in trace.drain_spans()[0]}
    finally:
        trace.disable()
    assert rows[True] > 0.01 > rows[False]


@pytest.mark.gpu
def test_serve_step_span_around_a_capturing_step_on_card(card, tmp_path):
    """The serve's spans around a decode that captures its CUDA graph (every
    first step of a key) raise nothing: one serve_step span per decode step,
    one prefill span per request, and the obs dir's files parse back."""
    from repro_torch.obs.export import load_snapshots, parse_prometheus
    from repro_torch.obs.latency import load_latency_table, table_provenance

    argv = ["--arch", "qwen3-32b", "--reduced", "--requests", "3",
            "--batch-slots", "2", "--prompt-len", "4", "--cache-len", "16",
            "--max-new", "4", "--reuse", "--obs-dir", str(tmp_path)]
    cfg = get_config("qwen3-32b").reduced()
    res = tserve_cli.run(cfg, tserve_cli.build_parser().parse_args(argv))
    assert res["step"].graphs and res["step"].summary()["captures"] >= 2
    rows = [json.loads(ln) for ln in (tmp_path / "spans.jsonl").open()]
    names = [r["name"] for r in rows]
    assert names.count("serve_step") == res["stats"]["steps"]
    assert names.count("prefill") == 3
    parse_prometheus((tmp_path / "metrics.prom").read_text())
    assert load_snapshots(str(tmp_path / "metrics.jsonl"))
    table = load_latency_table(str(tmp_path / "latency_table.json"))
    assert table_provenance(table) == "compiled"


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-7b", "nemotron-4-15b"])
def test_timeline_of_a_marked_decode_graph_on_card(card, arch):
    """Traced decode steps alternating between the graph captured with the
    per-site marks and the unmarked one: the logits are bitwise an
    untraced run's over the same steps, both graphs launch what the
    untraced graph launches, and the untraced key is the unmarked one's;
    every replay's device record lies inside its host span (its end within
    5 ms after the span closes); each marked replay's marks hold every
    site once per layer, each phase >= 0, their sum within the replay's
    own time."""
    from repro_torch.obs import trace
    from repro_torch.serve.compiled_step import MARKED
    from repro_torch.serve.serve_step import greedy_to_host

    runs = []
    for traced in (False, True):
        step = _reduced_step(arch, card, graphs=True)
        gen = torch.Generator(device=card).manual_seed(0)
        prompt = torch.randint(0, step.cfg.vocab, (2, 8), generator=gen,
                               device=card)
        if traced:
            trace.enable()
        try:
            logits = [step.prefill(prompt).clone()]
            tok = greedy_to_host(logits[0][:, -1:])
            for i in range(8):
                trace.set_marks(i % 2 == 0)
                logits.append(step.decode(tok).clone())
                tok = greedy_to_host(logits[-1])
            rows, dropped = trace.drain_spans()
        finally:
            trace.disable()
        launches = {k: v.launches for k, v in step.variants.items()
                    if k[0] == "decode"}
        runs.append((logits, launches, rows, dropped, step))
    (l0, c0, _, _, _), (l1, c1, rows, dropped, step) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    (k0, n0), = c0.items()
    assert c1 == {k0: n0, k0 + (MARKED,): n0}
    assert dropped == 0
    host = {r["span_id"]: r for r in rows if "t0" in r}
    reps = [r for r in rows if r["name"] == "compiled_step.decode.replay"]
    # the first step of each graph built it
    assert sorted(r["marked"] for r in reps) == [False] * 3 + [True] * 3
    n_layers = step.cfg.n_superblocks
    for rep in reps:
        span = host[rep["parent_id"]]
        assert span["name"] == "compiled_step.decode"
        assert span["t0"] <= rep["dev_t0"] <= rep["dev_t1"] <= span["t1"] + 5e-3
        assert rep["dur_s"] == pytest.approx(rep["dev_t1"] - rep["dev_t0"],
                                             abs=1e-5)
        assert ("marks" in rep) == rep["marked"]
        if not rep["marked"]:
            continue
        seen = {}
        for site, ordinal, phase, ms in rep["marks"]:
            assert ms >= 0.0, (site, ordinal, phase)
            seen.setdefault((site, phase), []).append(ordinal)
        for site in step.engine.sites:
            for phase in ("quant", "product", "epilogue"):
                assert seen[(site, phase)] == list(range(n_layers))
        assert seen[("head", "head")] == [0]
        total = sum(m[3] for m in rep["marks"])
        assert total <= (rep["dev_t1"] - rep["dev_t0"]) * 1e3 + 1e-3


@pytest.mark.gpu
def test_graph_probe_equals_eager_probe_on_card(card):
    """The latency probe through CUDA graphs and run directly leaves
    bitwise-equal final site caches for every (site, path), at a shape
    where every path (basic, kernel, ragged) runs."""
    from repro_torch.core.engine import ReuseEngine
    from repro_torch.obs.latency import probe_latency_table

    engine = ReuseEngine(impl="cuda")
    engine.register("s", 1024, 256, block_m=8, block_k=256)
    engine.register("t", 4096, 512, block_m=8, block_k=256)
    assert engine.sites["t"].dataflow == "input"
    caches = {}
    for graphs in (True, False):
        caches[graphs] = {}
        table = probe_latency_table(engine, 8, skip_rates={"s": 0.5},
                                    iters=3, warmup=2, device=card,
                                    graphs=graphs, caches=caches[graphs])
        assert set(table.paths_for("s")) == {"basic", "kernel", "ragged"}
    assert caches[True].keys() == caches[False].keys()
    for key, got in caches[True].items():
        want = caches[False][key]
        for leaf in ("prev_q", "prev_out", "sim_ema", "steps"):
            assert torch.equal(got[leaf], want[leaf]), (key, leaf)
        for name, t in got["sensor"].items():
            assert torch.equal(t, want["sensor"][name]), (key, name)


# two ranks, one card each: the placed engine's decode site call (its
# panel, then NCCL's all-gather of the panels) captured in a CUDA graph and
# replayed, against the one-device sharded engine on the same inputs
_NCCL_RANKS = r"""
import faulthandler, json, sys
import torch
faulthandler.dump_traceback_later(60, repeat=True)
from repro_torch.core.engine import ReuseEngine
from repro_torch.launch.mesh import parse_mesh_spec, place_mesh, \
    start_process_group

rank, world, dev = start_process_group("cuda")
mesh = place_mesh(parse_mesh_spec("host:2"), rank, world, dev)


def build(placement):
    eng = ReuseEngine(impl="cuda")
    eng.register("site", 4096, 1536, block_m=8, block_k=256)
    eng.shard_sites(2)
    eng.place(placement)
    cache = eng.init_cache(8, device=dev)
    eng.set_mode(cache, "site", "reuse")
    return eng, cache


gen = torch.Generator(device=dev).manual_seed(0)
w = (torch.randn((4096, 1536), generator=gen, device=dev) / 64).to(
    torch.bfloat16)
xs = [torch.randn((8, 4096), generator=gen, device=dev).to(torch.bfloat16)
      for _ in range(5)]
for x in xs[1:]:  # correlated steps: most tiles skip
    x[:, :3072] = xs[0][:, :3072]
one, c1 = build(None)
placed, c2 = build(mesh.placement)
want = [one.apply("site", x, w, None, c1["site"])[0].clone() for x in xs]
x_buf = xs[0].clone()
side = torch.cuda.Stream(dev)
side.wait_stream(torch.cuda.current_stream(dev))
with torch.cuda.stream(side):
    got = [placed.apply("site", x_buf, w, None, c2["site"])[0].clone()]
    placed.placement.all_gather(torch.zeros(1, device=dev))
torch.cuda.synchronize(dev)
graph = torch.cuda.CUDAGraph()
# as CompiledStep captures a placed step
with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
    out = placed.apply("site", x_buf, w, None, c2["site"])[0]
for x in xs[1:]:
    x_buf.copy_(x)
    graph.replay()
    got.append(out.clone())
torch.cuda.synchronize(dev)
lane = {k: c2["site"][k] for k in ("prev_q", "prev_out", "sim_ema")}
res = {"rank": rank,
       "outputs_equal": [torch.equal(a, b) for a, b in zip(got, want)],
       "lane_equal": {k: torch.equal(v, c1["site"][k].narrow(
           0, mesh.placement.shard, 1)) for k, v in lane.items()}}
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump(res, f)
# the graph holds the group's NCCL work: released before the group
graph.reset()
torch.cuda.synchronize(dev)
torch.distributed.destroy_process_group()
"""


@pytest.mark.gpu
def test_placed_panels_all_gathered_in_a_graph_on_two_cards(card, tmp_path):
    """Two ranks (torchrun, NCCL), each holding one shard: the site call
    captured with its NCCL all-gather and replayed gives, at every step,
    the one-device sharded engine's output bitwise, and each rank's cache
    lane is that lane of the one-device cache."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    import signal
    import socket

    script = tmp_path / "ranks.py"
    script.write_text(_NCCL_RANKS)
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), NCCL_DEBUG="WARN")
    # a static rendezvous at 127.0.0.1: the card's machine resolves no
    # host name
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = tmp_path / "ranks.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
             "--master-port", str(port), str(script), str(tmp_path)],
            env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            proc.wait(timeout=150)
        except subprocess.TimeoutExpired:
            # torchrun passes SIGTERM to its ranks
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            pytest.fail(f"the ranks hung: {log.read_text()[-4000:]}")
    assert proc.returncode == 0, log.read_text()[-4000:]
    for rank in range(2):
        res = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert all(res["outputs_equal"]), res
        assert all(res["lane_equal"].values()), res
