"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serve path through them. Marked `gpu`; each test skips
without a CUDA device of capability >= 9.0, deciding inside a fixture.
This file imports no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.core.delta import compact_rows
from repro_torch.kernels import backend
from repro_torch.kernels.delta_quant import delta_quant, delta_quant_torch
from repro_torch.kernels.reuse_matmul import reuse_matmul, reuse_matmul_torch
from repro_torch.kernels.reuse_matmul_ragged import (
    reuse_matmul_ragged,
    reuse_matmul_ragged_torch,
)
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
def test_serve_runs_the_kernels_on_the_card(card, capsys):
    backend.reset_launches()
    tserve_cli.main(["--arch", "qwen3-32b", "--reduced", "--requests", "2",
                     "--batch-slots", "2", "--prompt-len", "4",
                     "--cache-len", "16", "--max-new", "3", "--reuse"])
    counts = backend.launch_counts()
    assert counts["delta_quant"] > 0 and counts["reuse_matmul_output"] > 0
    assert "served 2/2 requests" in capsys.readouterr().out
