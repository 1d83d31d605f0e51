"""The port's analytic roofline model against the reference's, on the CPU.

`repro_torch.roofline.model_cost` and `.validate` are the reference's Python
float arithmetic in the same order, so every output is held with `==`. The
reference prices at TPU v5e rates; its module constants are patched to the
port's H100 SXM5 datasheet figures for the comparison (a fixture, not an
edit of the reference). `ModelConfig.param_count` and `active_param_count`
are compared for every arch, and the decode FLOPs the model predicts are
held against a FlopCounterMode count of one eager decode step of the port.
"""

import json
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as JARCHS
from repro.launch.specs import SHAPES as JSHAPES
from repro.roofline import model_cost as jmc
from repro.roofline import validate as jval
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.specs import SHAPES, ShapeCell, cell_runnable
from repro_torch.models.transformer import (
    forward,
    init_decode_state,
    init_params,
    output_logits,
)
from repro_torch.roofline import model_cost as tmc
from repro_torch.roofline import validate as tval
from test_backend import _sweep_rows

MESHES = ((16, 16, 1), (16, 16, 2), (1, 1, 1))


@pytest.fixture
def patched(monkeypatch):
    """The reference's model priced at the port's constants."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "MACHINE_BALANCE"):
        monkeypatch.setattr(jmc, name, getattr(tmc, name))


def test_constants_are_the_h100_datasheet_figures():
    assert (tmc.PEAK_FLOPS, tmc.HBM_BW, tmc.ICI_BW) == (989e12, 3.35e12,
                                                         450e9)
    assert tmc.MACHINE_BALANCE == tmc.PEAK_FLOPS / tmc.HBM_BW
    assert (tmc.BF16, tmc.F32) == (jmc.BF16, jmc.F32)
    for name in ("POD_MESH", "MULTIPOD_MESH"):
        a, b = getattr(tmc, name), getattr(jmc, name)
        assert (a.dp, a.tp, a.pods, a.n_devices) == (b.dp, b.tp, b.pods,
                                                     b.n_devices)
    assert tmc.MeshSpec(1, 1).n_devices == 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_reference(arch):
    for cfg, jcfg in ((ARCHS[arch], JARCHS[arch]),
                      (ARCHS[arch].reduced(), JARCHS[arch].reduced())):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


def _costs(mod, cfg, cell, mesh, **kw):
    c = mod.cell_cost(cfg, cell, mod.MeshSpec(*mesh), **kw)
    return (c.flops, c.hbm_bytes, c.coll_bytes, c.notes, c.compute_s,
            c.memory_s, c.collective_s, c.dominant, c.step_s)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_cost_matches_reference(patched, arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    kws = [{}]
    if cfg.n_experts:
        kws += [{"reuse_covers_experts": True, "expert_stickiness": 0.37},
                {"reuse_covers_experts": True, "expert_stickiness": 1.0}]
    n = 0
    for shape in SHAPES:
        if not cell_runnable(arch, shape)[0]:
            continue
        for mesh in MESHES:
            for skip in (0.0, 0.5):
                for kw in kws:
                    got = _costs(tmc, cfg, SHAPES[shape], mesh,
                                 reuse_skip_fraction=skip, **kw)
                    want = _costs(jmc, jcfg, JSHAPES[shape], mesh,
                                  reuse_skip_fraction=skip, **kw)
                    assert got == want, (shape, mesh, skip, kw)
                    n += 1
        cell = SHAPES[shape]
        assert tmc.model_flops_per_step(cfg, cell) == \
            jmc.model_flops_per_step(jcfg, JSHAPES[shape])
    assert n >= 6


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_roofline_row_matches_reference(patched, mesh_name):
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            for skip in (0.0, 0.5):
                got = tmc.roofline_row(ARCHS[arch], shape, mesh_name,
                                       reuse_skip_fraction=skip)
                want = jmc.roofline_row(JARCHS[arch], shape, mesh_name,
                                        reuse_skip_fraction=skip)
                assert got == want, (arch, shape, skip)


KERNEL_SHAPES = ((8, 5120, 10240), (8, 25600, 5120), (64, 2048, 256),
                 (13, 300, 77))


@pytest.mark.parametrize("path", ["dense", "dense_gemm", "kernel", "masked",
                                  "masked_ref", "ref", "compact", "ragged",
                                  "ragged_xla"])
def test_kernel_work_model_matches_reference(patched, path):
    for m, k, n in KERNEL_SHAPES:
        for bm in (8, 16):
            for bk in (128, 256):
                for mak in (None, 1, 3, 10_000):
                    for skip in (0.0, 0.25, 0.5, 0.78, 0.9, 1.0, 1.3):
                        kw = dict(path=path, skip=skip, block_m=bm,
                                  block_k=bk, max_active_k=mak)
                        a = tmc.reuse_kernel_cost(m, k, n, **kw)
                        b = jmc.reuse_kernel_cost(m, k, n, **kw)
                        assert (a.path, a.flops, a.bytes, a.work) == (
                            b.path, b.flops, b.bytes, b.work)
                        assert tmc.predict_kernel_speedup(m, k, n, **kw) == \
                            jmc.predict_kernel_speedup(m, k, n, **kw)
                if path in ("compact", "ragged", "kernel"):
                    kw = dict(path=path, block_m=bm, block_k=bk)
                    assert tmc.predicted_break_even_skip(m, k, n, **kw) == \
                        jmc.predicted_break_even_skip(m, k, n, **kw)
    with pytest.raises(ValueError, match="unknown kernel path"):
        tmc.reuse_kernel_cost(8, 256, 256, path="nope", skip=0.5)


def _backend_cases():
    """The sweeps of the reference's own validation tests: measurements
    made from the model, a win at every skip, and a late crossing."""
    skips = (0.0, 0.25, 0.5, 0.75, 0.9)
    us = {}
    for skip in skips:
        us[skip] = {"dense_gemm": 100.0}
        for p in ("compact", "ragged"):
            pred = jmc.predict_kernel_speedup(
                64, 2048, 256, path=p, skip=skip, block_k=256,
                max_active_k=8 if p == "ragged" else None)
            us[skip][p] = 100.0 / pred
    early = {skip: {"dense_gemm": 100.0, "compact": 50.0} for skip in skips}
    late = {skip: {"dense_gemm": 100.0,
                   "compact": 80.0 if skip >= 0.75 else 300.0 - 100.0 * skip}
            for skip in skips}
    return [_sweep_rows(us), _sweep_rows(early), _sweep_rows(late)]


def _random_sweep(seed):
    """A seeded sweep at one site: dense, the parity paths and the
    compaction paths at each skip, with log-normal times."""
    rng = np.random.default_rng(seed)
    m = int(rng.choice([8, 16, 64]))
    k = int(rng.choice([2048, 5120, 25600]))
    n = int(rng.choice([256, 5120]))
    bk = int(rng.choice([128, 256]))
    paths = ["dense_gemm", "kernel", "compact", "ragged"]
    if seed % 2:
        paths += ["masked", "dense"]
    rows = []
    for skip in (0.0, 0.25, 0.5, 0.75, 0.9)[: 3 + seed % 3]:
        for p in paths:
            rows.append({"skip": skip, "path": p,
                         "us": float(rng.lognormal(4.0, 0.6)),
                         "m": m, "k": k, "n": n, "block_m": 8,
                         "block_k": bk,
                         "max_active_k": int(rng.integers(1, 9))
                         if p == "ragged" else None})
    return rows


@pytest.mark.parametrize("case", range(3 + 6))
def test_validate_kernel_sweep_matches_reference(patched, case):
    rows = _backend_cases()[case] if case < 3 else _random_sweep(case)
    got = tval.validate_kernel_sweep(rows)
    assert got == jval.validate_kernel_sweep(rows)
    loose = {"rank_corr_min": 0.1, "break_even_slack": 0.5}
    assert tval.validate_kernel_sweep(rows, tolerance=loose) == \
        jval.validate_kernel_sweep(rows, tolerance=loose)
    assert tval.KERNEL_SWEEP_TOLERANCE == jval.KERNEL_SWEEP_TOLERANCE
    if case == 0:
        assert got["ok"]
    if case == 1:
        assert not got["ok"] and not got["break_even_within_tol"]


def test_spearman_matches_reference():
    rng = np.random.default_rng(3)
    for n in (2, 3, 5, 9):
        a = [float(x) for x in rng.integers(0, 4, n)]
        b = [float(x) for x in rng.normal(size=n)]
        assert tval._spearman(a, b) == jval._spearman(a, b)
    assert tval._spearman([1.0, 1.0, 1.0], [1.0, 2.0, 3.0]) is None


def test_validate_and_main_match_reference(patched, tmp_path, monkeypatch,
                                           capsys):
    rng = np.random.default_rng(5)
    for arch in sorted(ARCHS):
        if not cell_runnable(arch, "decode_32k")[0]:
            continue
        pred = jval.predicted_decode_hlo_flops(JARCHS[arch],
                                               JSHAPES["decode_32k"])
        rec = {"arch": arch, "status": "ok", "cost_analysis": {
            "flops": pred * float(rng.uniform(0.8, 1.3))}}
        (tmp_path / f"{arch}__decode_32k.json").write_text(json.dumps(rec))
    (tmp_path / "qwen3-32b__train_4k.json").write_text(json.dumps(
        {"arch": "qwen3-32b", "status": "ok", "cost_analysis": {"flops": 1}}))
    (tmp_path / "x__decode_32k.json").write_text(json.dumps(
        {"arch": "x", "status": "error: lowering failed"}))
    (tmp_path / "y__decode_32k.json").write_text(json.dumps(
        {"arch": "y", "status": "ok", "cost_analysis": None}))
    got = tval.validate(str(tmp_path))
    assert got == jval.validate(str(tmp_path))
    assert len(got) == 9
    for arch in ARCHS:
        for mesh in MESHES:
            for shape in ("decode_32k", "long_500k"):
                assert tval.predicted_decode_hlo_flops(
                    ARCHS[arch], SHAPES[shape], tmc.MeshSpec(*mesh)) == \
                    jval.predicted_decode_hlo_flops(
                        JARCHS[arch], JSHAPES[shape], jmc.MeshSpec(*mesh))
    monkeypatch.setattr(sys, "argv", ["validate", str(tmp_path)])
    jval.main()
    want = capsys.readouterr().out
    tval.main([str(tmp_path)])
    assert capsys.readouterr().out == want
    assert want.count("\n") == 10
    with pytest.raises(SystemExit, match="usage"):
        tval.main([])


@pytest.mark.parametrize("arch,batch,cache_len", [
    ("qwen3-32b", 4, 64), ("qwen3-32b", 2, 160), ("nemotron-4-15b", 3, 96)])
def test_decode_flops_match_the_model(arch, batch, cache_len):
    """One eager decode step of the reduced dense model (reuse off: every
    product is an aten op) counted by FlopCounterMode, against
    predicted_decode_hlo_flops at MeshSpec(1, 1) with seq_len the KV extent
    the step attends (its whole cache: the masked softmax reads every
    slot). The count equals the prediction (ratio 1.0): the projections,
    the MLP and the head are mm, the scores and the weighted sum bmm, and
    grouped-GQA contracts q's heads against the KV heads without repeating
    them, so the 4·t·S·H·D of the model is what runs. Held within ±5%."""
    torch.manual_seed(0)
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    state = init_decode_state(cfg, batch, cache_len, device="cpu")
    state["len"].fill_(cache_len // 2)
    tokens = torch.randint(0, cfg.vocab, (batch, 1), dtype=torch.int32)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        h, _, _, _ = forward(params, cfg, {"tokens": tokens},
                             decode_state=state)
        output_logits(params, cfg, h)
    cell = ShapeCell("decode", "decode", cache_len, batch)
    pred = tval.predicted_decode_hlo_flops(cfg, cell, tmc.MeshSpec(1, 1))
    ratio = fc.get_total_flops() / pred
    assert abs(ratio - 1.0) <= 0.05, ratio
