"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serve path through them. Marked `gpu`; each test skips
without a CUDA device of capability >= 9.0, deciding inside a fixture.
This file imports no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import math

import pytest
import torch

from repro_torch.core.delta import compact_rows, delta_encode_int8
from repro_torch.kernels import backend, ops
from repro_torch.kernels.delta_quant import delta_quant, delta_quant_torch
from repro_torch.kernels.reuse_matmul import reuse_matmul, reuse_matmul_torch
from repro_torch.kernels.reuse_matmul_int8 import reuse_matmul_int8_torch
from repro_torch.kernels.reuse_matmul_ragged import (
    reuse_matmul_ragged,
    reuse_matmul_ragged_torch,
)
from repro_torch.kernels.wkv6_decode import wkv6_decode, wkv6_decode_torch
from repro_torch.launch import serve as tserve_cli

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_quant_matches_plain_on_card(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((16, 1024), generator=gen, device=card) * 2).to(dtype)
    scale = torch.tensor(0.0625, device=card)
    prev_q = torch.randint(-127, 128, (16, 1024), generator=gen,
                           device=card).to(torch.int8)
    prev_q[:8] = torch.clamp(torch.round(x[:8].float() / scale), -127,
                             127).to(torch.int8)
    got = delta_quant(x, prev_q, scale, block_m=8, block_k=256,
                      delta_dtype=dtype)
    want = delta_quant_torch(x, prev_q, scale, block_m=8, block_k=256,
                             delta_dtype=dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2][0].sum()) == 0 and bool(got[2][1].all())


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
    ("qwen3-32b", ("delta_quant", "reuse_matmul_output")),
    ("rwkv6-7b", ("delta_quant", "reuse_matmul_output", "wkv6_decode"))])
def test_serve_runs_the_kernels_on_the_card(card, capsys, arch, kernels):
    backend.reset_launches()
    tserve_cli.main(["--arch", arch, "--reduced", "--requests", "2",
                     "--batch-slots", "2", "--prompt-len", "4",
                     "--cache-len", "16", "--max-new", "3", "--reuse"])
    counts = backend.launch_counts()
    assert all(counts[kn] > 0 for kn in kernels), counts
    assert "served 2/2 requests" in capsys.readouterr().out
