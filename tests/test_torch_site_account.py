"""A site call's bookkeeping (`kernels/site_account.py`) against the
reference's `reuse_linear`, lane by lane and bit by bit.

Each case runs the reference's compiled site call (`jax.jit`, impl
"pallas", which resolves to the compiled-XLA tier on this host) for two
steps from cache lanes seeded with NaN, ±inf and values whose FMA differs
from a product and a sum rounded apart, and runs the port's plain version
`site_account_torch` on the same codes and masks. Every lane the call writes
must come out bitwise the reference's, NaN positions included (a NaN's
payload is not compared: the card's FMA returns the canonical NaN). The
cases cover reuse and basic mode, the four exec paths, both dataflows, a
budget that overflows and one that does not, and the ownership partition of
a sharded call at S = 2 and 4. The kernel's by-value arguments (`plan`) are
held to the same lanes through a numpy model of its epilogue.

The reuse-mode call's fused entry (`ops.delta_quant_account`, the
delta/quant/mask pass and the bookkeeping as one kernel on the card) is
held the same way at batches of 2 and 8 and a K tail, its delta and mask
against the reference's padding entry, and its per-tile match counts
through a numpy model of the kernel's partials."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.reuse_cache import ReuseSiteSpec as JSpec
from repro.core.reuse_cache import init_site_cache as jinit_site_cache
from repro.core.reuse_linear import reuse_linear as jreuse_linear
from repro.kernels import ops as jops
from repro.kernels.reuse_matmul import _skip_sel as jskip_sel
from repro.sensor.counters import ShardCtx as JShardCtx
from repro_torch.core.reuse_cache import ReuseSiteSpec, init_site_cache
from repro_torch.core.reuse_linear import ReuseStats, reuse_linear
from repro_torch.core.similarity import fma_f32, row_code_matches
from repro_torch.kernels import ops
from repro_torch.kernels import site_account as sa
from repro_torch.kernels.reuse_matmul import skip_sel, weight_dma_tiles
from repro_torch.quant import quantize_int8
from repro_torch.sensor.counters import ShardCtx

M, K, N = 12, 320, 640           # gm 2 (rows 12-15 padding), gk 5, gn 5
BM, BK, BN = 8, 64, 128
SCALE = 0.05
DECAY = 0.9
FLOAT_SCALARS = ("skipped_macs", "computed_macs", "skipped_weight_bytes",
                 "total_weight_bytes", "reused_out_elems", "grid_steps")
INT_SCALARS = ("skipped_tiles", "computed_tiles", "dma_issued_tiles",
               "overflow_fallbacks", "mode_transitions")


@dataclasses.dataclass(frozen=True)
class Case:
    mode: str = "reuse"
    path: str = "kernel"
    dataflow: str = "output"
    shards: int = 0              # 0: unsharded
    budget: int | None = None    # max_active_k; 1 overflows, None never
    poison: bool = False         # NaN and ±inf in the scalar float lanes
    m: int = M                   # rows (the batch)
    k: int = K                   # in_features

    def __str__(self):
        parts = [self.mode]
        if self.mode == "reuse":
            parts += [self.path, self.dataflow]
            if self.path in ("ragged", "compact"):
                parts.append("over" if self.budget == 1 else "fits")
        parts.append(f"S{self.shards}" if self.shards else "unsharded")
        if self.poison:
            parts.append("poison")
        if (self.m, self.k) != (M, K):
            parts.append(f"{self.m}x{self.k}")
        return "-".join(parts)


CASES = (
    [Case(path=p, dataflow=d, shards=s)
     for p in ("kernel", "dense") for d in ("output", "input")
     for s in (0, 2, 4)]
    + [Case(path=p, budget=b, shards=s)
       for p in ("ragged", "compact") for b in (1, None) for s in (0, 2, 4)]
    + [Case(mode="basic", dataflow=d, shards=s)
       for d in ("output", "input") for s in (0, 2, 4)]
    + [Case(poison=True), Case(path="ragged", budget=1, shards=2,
                               poison=True),
       Case(mode="basic", shards=4, poison=True)]
)


def two_roundings(a, b, c):
    """f32 a·b + c with the product and the sum rounded apart."""
    return np.float32(np.float32(a) * np.float32(b)) + np.float32(c)


def fma_f64(a, b, c):
    """f32 fma(a, b, c) through f64 (exact product; the f64 sum's own
    rounding only matters on ties, which the search below skips)."""
    return np.float32(np.float64(np.float32(a)) * np.float64(np.float32(b))
                      + np.float64(np.float32(c)))


def sensitive(rng, b, c):
    """An f32 value a in [0, 1) whose fma(a, b, c) differs from a·b + c
    rounded twice."""
    for _ in range(10_000):
        a = np.float32(rng.random())
        if fma_f64(a, b, c) != two_roundings(a, b, c):
            return a
    raise AssertionError(f"no a with fma(a, {b}, {c}) != a·b + c")


def exact_product(a, b):
    return np.float64(np.float32(a)) * np.float64(np.float32(b)) == \
        np.float32(a) * np.float32(b)


def sensitive_addend(rng, a, b):
    """An f32 value c in [1, 9) whose fma(a, b, c) differs from a·b + c
    rounded twice (any c where the product a·b is exact in f32)."""
    if exact_product(a, b):
        return np.float32(1.0 + 8.0 * rng.random())
    for _ in range(10_000):
        c = np.float32(1.0 + 8.0 * rng.random())
        if fma_f64(a, b, c) != two_roundings(a, b, c):
            return c
    raise AssertionError(f"no c with fma({a}, {b}, c) != a·b + c")


def codes(rng, prev, gm_mask):
    """Codes that differ from `prev` exactly in the (BM × BK) tiles of
    `gm_mask` (a few codes of each such tile move by 1..5)."""
    cur = prev.copy()
    for r, c in zip(*np.nonzero(gm_mask)):
        rows = slice(r * BM, min((r + 1) * BM, prev.shape[0]))
        tile = cur[rows, c * BK:(c + 1) * BK]
        hit = rng.random(tile.shape) < 0.3
        tile[hit] = np.clip(tile[hit] + rng.integers(1, 6, hit.sum()),
                            -127, 127)
        first = prev[r * BM, c * BK]
        tile[0, 0] = first - 1 if first > 0 else first + 1
    return cur


def seeded_lanes(rng, case, c0, c1, live):
    """The lanes every case starts from (numpy), shared by both packages:
    prev_q = c0; per-row lanes NaN, ±inf and FMA-sensitive values for the
    first call's match counts (and, for the occupancy, its `live` changed
    tiles); the scalar lanes finite values that round when added to, or
    NaN and ±inf (`poison`)."""
    M, K = c0.shape
    matches = (c0 == c1).sum(axis=1).astype(np.float32)
    c_sim = np.float32(1.0 - DECAY) * np.float32(1.0 / K)
    inv_k = np.float32(1.0 / K)
    c_occ = np.float32(1.0 - DECAY) * np.float32(1.0 / live.size)
    sim = np.array([sensitive(rng, DECAY, matches[m] * c_sim)
                    for m in range(M)], np.float32)
    hits = np.array([sensitive_addend(rng, matches[m], inv_k)
                     for m in range(M)], np.float32)
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)[:min(3, M)]
    sim[:len(bad)] = bad
    at = 3 if M >= 6 else M - len(bad)   # rows 3-5, or the last rows
    hits[at:at + len(bad)] = bad
    lanes = {
        "prev_q": c0, "sim_ema": sim, "steps": np.int32(7),
        "occupancy": sensitive(rng, DECAY,
                               np.float32(live.sum()) * c_occ),
        "slot_hit_sum": hits,
        "slot_steps": rng.integers(0, 9, M).astype(np.int32),
        "mode_flag": np.int32(0 if case.mode == "reuse" else 1),
    }
    for name in FLOAT_SCALARS:
        lanes[name] = np.float32(rng.random() * 3e7 + 0.3)
    for name in INT_SCALARS:
        lanes[name] = np.int32(rng.integers(0, 1000))
    if case.poison:
        poison = [np.nan, np.inf, -np.inf]
        for i, name in enumerate(FLOAT_SCALARS + ("occupancy",)):
            lanes[name] = np.float32(poison[i % 3])
    return lanes


def jax_cache(spec, lanes):
    entry = jinit_site_cache(spec, len(lanes["sim_ema"]))
    sensor = dict(entry["sensor"])
    ctrl = dict(entry["ctrl"])
    for name, v in lanes.items():
        if name in sensor:
            sensor[name] = jnp.asarray(v)
        elif name in ctrl:
            ctrl[name] = jnp.asarray(v)
        else:
            entry[name] = jnp.asarray(v)
    return dict(entry, sensor=sensor, ctrl=ctrl)


def torch_cache(spec, lanes):
    entry = init_site_cache(spec, len(lanes["sim_ema"]), device="cpu")
    for name, v in lanes.items():
        for tree in (entry, entry["sensor"], entry["ctrl"]):
            if name in tree:
                tree[name].copy_(torch.from_numpy(np.asarray(v).copy()))
    return entry


def lane_dict(entry) -> dict[str, np.ndarray]:
    """Every lane a site call writes, as numpy."""
    out = {name: entry[name] for name in ("prev_q", "sim_ema", "steps")}
    out["occupancy"] = entry["ctrl"]["occupancy"]
    out.update({f"sensor.{k}": v for k, v in entry["sensor"].items()})
    return {k: np.array(v) for k, v in out.items()}  # copies


def assert_lanes_equal(got, want, what):
    """Bitwise, NaN positions included; a NaN's payload is not compared."""
    assert set(got) == set(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        if a.dtype.kind == "f":
            nan = np.isnan(b)
            np.testing.assert_array_equal(np.isnan(a), nan,
                                          err_msg=f"{what}: {name} NaNs")
            a, b = a[~nan], b[~nan]
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


def site_geometry(case):
    """(port spec, reference spec, n, shard contexts, weight columns)."""
    kw = dict(in_features=case.k, block_m=BM, block_k=BK, block_n=BN,
              mode=case.mode, dataflow=case.dataflow,
              exec_path=case.path, max_active_k=case.budget,
              fixed_scale=SCALE)
    if not case.shards:
        return (ReuseSiteSpec("s", out_features=N, **kw),
                JSpec("s", out_features=N, **kw), N, None, None)
    nl = N // case.shards
    gn_total = -(-N // BN)
    return (ReuseSiteSpec("s", out_features=nl, **kw),
            JSpec("s", out_features=nl, **kw), nl,
            (ShardCtx(1, case.shards, N, gn_total),
             JShardCtx(jnp.int32(1), case.shards, N, gn_total)),
            slice(nl, 2 * nl))


@pytest.fixture(scope="module", params=CASES, ids=str)
def run(request):
    """One case: the reference's two compiled site calls and the port's
    plain bookkeeping on the same codes, from the same seeded lanes."""
    case = request.param
    rng = np.random.default_rng(CASES.index(case) + 17)
    spec, jspec, n, shard, cols = site_geometry(case)
    gm, gk = -(-M // BM), -(-K // BK)
    c0 = rng.integers(-100, 101, (M, K)).astype(np.int8)
    first = rng.random((gm, gk)) < 0.5
    first[1] = False                       # row block 1 wholly unchanged
    first[0, :2] = True                    # row block 0 over a budget of 1
    c1 = codes(rng, c0, first)
    c2 = codes(rng, c1, rng.random((gm, gk)) < 0.6)
    lanes = seeded_lanes(rng, case, c0, c1, first)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    if cols is not None:
        w = w[:, cols]
    jshard = None if shard is None else shard[1]
    tshard = None if shard is None else shard[0]

    @jax.jit
    def jstep(x, entry, idx):
        sh = None if jshard is None else jshard._replace(index=idx)
        _, entry, stats = jreuse_linear(x, jnp.asarray(w), None, entry,
                                        jspec, mode=case.mode, impl="pallas",
                                        ema_decay=DECAY, shard=sh)
        return entry, stats

    jentry = jax_cache(jspec, lanes)
    tentry = torch_cache(spec, lanes)
    steps = []
    for c in (c1, c2):
        x = (c.astype(np.float32) * np.float32(SCALE)).astype(np.float32)
        jentry, jstats = jstep(jnp.asarray(x), jentry, jnp.int32(1))
        xt = torch.from_numpy(x)
        prev = tentry["prev_q"].clone()
        if case.mode == "basic":
            cur_q, mask = quantize_int8(xt, tentry["scale"]), None
        else:
            cur_q, _, mask = ops.delta_quant_fused(
                xt, tentry["prev_q"], tentry["scale"], block_m=BM,
                block_k=BK, impl="torch")
        before = lane_dict(tentry)
        matches = sa.site_account_torch(
            cur_q, mask, tentry, path=case.path, dataflow=case.dataflow,
            block_m=BM, block_k=BK, n=n, gn=-(-n // BN), w_itemsize=4,
            ema_decay=DECAY, budget=case.budget, shard=tshard)
        steps.append(dict(
            ref=lane_dict(jentry), got=lane_dict(tentry), before=before,
            mask=mask, matches=matches, prev_q=prev, cur_q=cur_q,
            stats=ReuseStats(matches, mask, K),
            ref_stats=(np.asarray(jstats.similarity),
                       np.asarray(jstats.skip_fraction))))
    return case, spec, n, tshard, steps


def test_lanes_bitwise_reference(run):
    case, _, _, _, steps = run
    for i, step in enumerate(steps):
        assert_lanes_equal(step["got"], step["ref"], f"{case} step {i}")


def test_seeded_lanes_tell_the_roundings_apart(run):
    """The first call's sim_ema and slot_hit_sum (and the occupancy, in
    reuse mode) differ from what a product and a sum rounded apart give, so
    a version that rounds either lane the other way fails."""
    case, _, _, _, steps = run
    s = steps[0]
    m = s["matches"].numpy()
    c_sim = np.float32(1.0 - DECAY) * np.float32(1.0 / K)
    sim0, hit0 = s["before"]["sim_ema"], s["before"]["sensor.slot_hit_sum"]
    fin = np.isfinite(sim0)
    apart = two_roundings(sim0, np.float32(DECAY), m * c_sim)
    assert (s["ref"]["sim_ema"][fin] != apart[fin]).all()
    rows = np.isfinite(hit0) & ~exact_product(m, np.float32(1.0 / K))
    assert rows.any()
    apart = two_roundings(m, np.float32(1.0 / K), hit0)
    assert (s["ref"]["sensor.slot_hit_sum"][rows] != apart[rows]).all()
    if case.mode == "reuse" and not case.poison:
        total = np.float32(s["mask"].sum())
        c_occ = np.float32(1.0 - DECAY) * np.float32(1.0 / s["mask"].numel())
        assert s["ref"]["occupancy"] != two_roundings(
            s["before"]["occupancy"], np.float32(DECAY), total * c_occ)


def test_stats_on_demand_equal_reference(run):
    case, _, _, _, steps = run
    for step in steps:
        sim, skip = step["ref_stats"]
        got = step["stats"]
        assert got.similarity.dtype == torch.float32
        np.testing.assert_array_equal(got.similarity.numpy(), sim)
        np.testing.assert_array_equal(got.skip_fraction.numpy(), skip)


def kernel_model(ints, floats, before, mask, matches, kb):
    """numpy model of `csrc/site_account.cu`'s epilogue on the plan's
    arguments: what the kernel writes, from the lanes it reads."""
    f = {k: np.float32(v) for k, v in floats.items()}
    g = ints
    out = {k: np.array(v, copy=True) for k, v in before.items()}
    mt = np.asarray(matches, np.float32)
    out["sim_ema"] = fma_f32(torch.from_numpy(before["sim_ema"]), f["decay"],
                             torch.from_numpy(mt * f["c_sim"])).numpy()
    out["sensor.slot_hit_sum"] = fma_f32(
        torch.from_numpy(mt), f["inv_k"],
        torch.from_numpy(before["sensor.slot_hit_sum"])).numpy()
    out["sensor.slot_steps"] = before["sensor.slot_steps"] + np.int32(1)
    out["steps"] = before["steps"] + np.int32(1)

    def add(name, v):
        out[f"sensor.{name}"] = np.float32(out[f"sensor.{name}"]) + \
            np.float32(v)

    if g["basic"]:
        out["sensor.computed_tiles"] += np.int32(g["total"])
        add("computed_macs", f["total_macs"])
        add("total_weight_bytes", f["total_w"])
        out["sensor.dma_issued_tiles"] += np.int32(g["gm"] * g["gk"] * g["g"])
        add("grid_steps", f["grid_full"])
        flag = 0
    else:
        mk = np.asarray(mask)
        cols = np.arange(g["gk"])
        own_cols = (cols % g["shard_count"] == g["shard_index"]
                    if g["shard_count"] else np.ones(g["gk"], bool))
        own = np.int32(mk[:, own_cols].sum())
        rows = (mk != 0).sum(axis=1)
        out["occupancy"] = fma_f32(
            torch.tensor(before["occupancy"]), f["decay"],
            torch.tensor(np.float32(mk.sum()) * f["c_occ"])).numpy()
        skipped = np.int32(g["total"] - own)
        out["sensor.skipped_tiles"] += skipped
        out["sensor.computed_tiles"] += own
        add("skipped_macs", np.float32(skipped) * f["macs"])
        add("computed_macs", np.float32(own) * f["macs"])
        add("skipped_weight_bytes", np.float32(skipped) * f["tile_w"])
        add("total_weight_bytes", f["total_w"])
        add("reused_out_elems", np.float32((rows == 0).sum()) * f["row_elems"])
        path = sa.PATHS[g["path"]]
        grid = f["grid_full"]
        if path in ("ragged", "compact"):
            live = int(mk.max(axis=0).sum())
            over = int((rows > kb).any()) if path == "ragged" else \
                int(live > kb)
            dma = int(np.maximum(rows, 1).sum()) if path == "ragged" else live
            grid = f["grid_over"] if over else np.float32(kb * g["grid_rate"])
            if g["shard_count"]:
                grid = np.float32(grid * f["panels"])
            out["sensor.overflow_fallbacks"] += np.int32(over)
        elif g["output"]:
            dma = int((mk[:, 1:] != 0).sum()) + g["gm"]
        else:
            dma = int((mk != 0).sum())
        out["sensor.dma_issued_tiles"] += np.int32(dma * g["g"])
        add("grid_steps", grid)
        flag = 1
    prev = int(before["sensor.mode_flag"])
    out["sensor.mode_transitions"] += np.int32(prev >= 0 and prev != flag)
    out["sensor.mode_flag"] = np.int32(flag)
    out["prev_q"] = None  # the row pass's; checked against cur_q below
    return out


def test_kernel_plan_gives_the_plain_lanes(run):
    """The kernel's by-value arguments, through a numpy model of its
    epilogue, give the plain version's lanes bitwise."""
    case, spec, n, shard, steps = run
    for i, s in enumerate(steps):
        mask = s["mask"]
        gm, gk = (mask.shape if mask is not None
                  else (-(-M // BM), -(-K // BK)))
        ints, floats = sa.plan(
            m=M, k=K, gm=gm, gk=gk, basic=mask is None, path=case.path,
            dataflow=case.dataflow, block_m=BM, block_k=BK, n=n,
            gn=-(-n // BN), w_itemsize=4, ema_decay=DECAY,
            budget=case.budget, shard=shard)
        assert set(ints) | {"m", "k", "ldq", "chunks", "vec", "has_ctrl",
                            "has_sensor"} == set(sa.INTS)
        assert set(floats) == set(sa.FLOATS)
        want = kernel_model(ints, floats, s["before"], mask, s["matches"],
                            ints["budget"])
        got = dict(s["got"])
        np.testing.assert_array_equal(got.pop("prev_q"), s["cur_q"].numpy())
        want.pop("prev_q")
        assert_lanes_equal(got, want, f"{case} step {i} (kernel model)")


@pytest.mark.parametrize("case", [Case(path="ragged", budget=1, shards=2),
                                  Case(mode="basic"), Case()], ids=str)
def test_reuse_linear_routes_through_site_account(case, monkeypatch):
    """`reuse_linear` leaves the lanes `site_account_torch` leaves: reuse
    mode through the fused entry `ops.delta_quant_account` (before the
    GEMM), basic mode through `ops.site_account`, each once a call, with a
    budget lane as the engine passes it."""
    spec, _, n, shard, cols = site_geometry(case)
    tshard = None if shard is None else shard[0]
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.normal(size=(K, N)) / 16).astype(np.float32))
    if cols is not None:
        w = w[:, cols]
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    calls = []
    for entry in ("delta_quant_account", "site_account"):
        def counted(*args, _entry=entry, _orig=getattr(ops, entry), **kw):
            calls.append((_entry, kw["budget"]))
            return _orig(*args, **kw)
        monkeypatch.setattr(ops, entry, counted)
    a = init_site_cache(spec, M, device="cpu")
    b = init_site_cache(spec, M, device="cpu")
    lane = torch.tensor(1, dtype=torch.int32)
    reuse_linear(x, w, None, a, spec, mode=case.mode, impl="torch",
                 ema_decay=DECAY, budget=lane, shard=tshard)
    assert calls == ([("delta_quant_account", lane)] if case.mode == "reuse"
                     else [("site_account", None)])
    if case.mode == "basic":
        cur_q, mask = quantize_int8(x, b["scale"]), None
    else:
        cur_q, _, mask = ops.delta_quant_fused(x, b["prev_q"], b["scale"],
                                               block_m=BM, block_k=BK,
                                               impl="torch")
    sa.site_account_torch(
        cur_q, mask, b, path=case.path, dataflow=case.dataflow, block_m=BM,
        block_k=BK, n=n, gn=-(-n // BN), w_itemsize=4, ema_decay=DECAY,
        budget=lane, shard=tshard)
    assert_lanes_equal(lane_dict(a), lane_dict(b), str(case))


@pytest.mark.parametrize("gm,gk,p", [(1, 1, 0.5), (1, 20, 0.5), (2, 5, 0.3),
                                     (16, 100, 0.2), (16, 100, 0.9),
                                     (4, 7, 1.0), (4, 7, 0.0)])
def test_sel_transitions_are_computed_tiles_past_k0(gm, gk, p):
    """sel is the running max of the computed k indices, clamped at 0, so a
    row's sel changes between k-1 and k exactly where mask[m, k] = 1 for
    k >= 1: output-stationary dma is (Σ_{k>=1} mask + gm)·gn, no cummax."""
    rng = np.random.default_rng(gm * 1000 + gk)
    for _ in range(20):
        mask = (rng.random((gm, gk)) < p).astype(np.int32)
        sel = skip_sel(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(sel, np.asarray(jskip_sel(mask)))
        changed = sel[:, 1:] != sel[:, :-1]
        np.testing.assert_array_equal(changed, mask[:, 1:] != 0)
        dma = weight_dma_tiles(torch.from_numpy(mask), gn=3, dataflow="output")
        assert int(dma) == (int(mask[:, 1:].sum()) + gm) * 3


def test_fma_f32_rounds_once_and_keeps_infinities():
    """fma_f32 against the reference's compiled FMA on triples where one
    rounding and two differ, and on infinite and NaN operands."""
    rng = np.random.default_rng(5)
    a = np.array([sensitive(rng, 0.9, 0.01) for _ in range(64)], np.float32)
    b = np.float32(0.9)
    c = np.full(64, 0.01, np.float32)
    a[:6] = [np.inf, -np.inf, 1.0, np.inf, np.nan, 3e38]
    c[:6] = [0.5, 0.5, np.inf, -np.inf, 1.0, 3e38]
    want = np.asarray(jax.jit(lambda a, c: a * b + c)(a, c))
    got = fma_f32(torch.from_numpy(a), float(b), torch.from_numpy(c)).numpy()
    assert_lanes_equal({"v": got}, {"v": want}, "fma_f32")
    assert (two_roundings(a[6:], b, c[6:]) != want[6:]).all()
    np.testing.assert_array_equal(want[[0, 1, 2, 5]],
                                  [np.inf, -np.inf, np.inf, np.inf])


def test_wrapper_takes_the_twin_on_the_cpu(monkeypatch):
    """A CPU tensor takes the plain version on impl "cuda"; nothing is
    counted as a launch."""
    from repro_torch.kernels import backend

    spec = ReuseSiteSpec("s", K, N, block_m=BM, block_k=BK)
    entry = init_site_cache(spec, M, device="cpu")
    backend.reset_launches()
    cur_q = torch.ones((M, K), dtype=torch.int8)
    m = ops.site_account(cur_q, None, entry, path="kernel", dataflow="output",
                         block_m=BM, block_k=BK, n=N, gn=5, w_itemsize=2,
                         ema_decay=DECAY, budget=None, impl="cuda")
    assert backend.launch_counts()["site_account"] == 0
    np.testing.assert_array_equal(m.numpy(), np.zeros(M, np.float32))
    assert (entry["prev_q"] == 1).all()


# ------------------------------- the reuse-mode call's fused entry

K_TAIL = 300                      # gk 5: the last tile holds 44 columns
FUSED_CASES = (
    [Case(path=p, m=m, k=K_TAIL,
          budget=1 if p in ("ragged", "compact") else None)
     for m in (2, 8) for p in ("kernel", "dense", "ragged", "compact")]
    + [Case(path="kernel", dataflow="input", shards=2, m=m, k=K_TAIL)
       for m in (2, 8)]
    + [Case(path="ragged", shards=4, m=m, k=K_TAIL) for m in (2, 8)]
)


@pytest.fixture(scope="module", params=FUSED_CASES, ids=str)
def fused(request):
    """One reuse-mode case at a batch of 2 or 8 and a K tail: the
    reference's two compiled site calls against `ops.delta_quant_account`
    (impl "cuda": the wrapper, which takes its plain version for CPU
    tensors) on the same x, from the same seeded lanes; and the reference's
    padding entry on the call's x and prev_q."""
    case = request.param
    rng = np.random.default_rng(FUSED_CASES.index(case) + 101)
    spec, jspec, n, shard, cols = site_geometry(case)
    m, k = case.m, case.k
    gm, gk = -(-m // BM), -(-k // BK)
    c0 = rng.integers(-100, 101, (m, k)).astype(np.int8)
    first = rng.random((gm, gk)) < 0.5
    first[0, :2] = True                    # over a budget of 1
    c1 = codes(rng, c0, first)
    c2 = codes(rng, c1, rng.random((gm, gk)) < 0.6)
    lanes = seeded_lanes(rng, case, c0, c1, first)
    w = (rng.normal(size=(k, N)) / np.sqrt(k)).astype(np.float32)
    if cols is not None:
        w = w[:, cols]
    jshard = None if shard is None else shard[1]
    tshard = None if shard is None else shard[0]

    @jax.jit
    def jstep(x, entry, idx):
        # the stats stay outputs, as in `run`: XLA's choice of which product
        # of the occupancy's a·b + c·d it contracts follows their uses
        sh = None if jshard is None else jshard._replace(index=idx)
        _, entry, stats = jreuse_linear(x, jnp.asarray(w), None, entry,
                                        jspec, mode="reuse", impl="pallas",
                                        ema_decay=DECAY, shard=sh)
        return entry, stats

    jentry = jax_cache(jspec, lanes)
    tentry = torch_cache(spec, lanes)
    ptrs = {name: t.data_ptr() for name, t in sa.written_lanes(tentry).items()}
    steps = []
    for c in (c1, c2):
        x = (c.astype(np.float32) * np.float32(SCALE)).astype(np.float32)
        _, jd, jm = jops.delta_quant_fused(
            jnp.asarray(x), jnp.asarray(tentry["prev_q"].numpy()),
            jnp.float32(SCALE), block_m=BM, block_k=BK,
            delta_dtype=jnp.float32, interpret=True)
        jentry, _ = jstep(jnp.asarray(x), jentry, jnp.int32(1))
        delta, mask, matches = ops.delta_quant_account(
            torch.from_numpy(x), tentry, block_m=BM, block_k=BK,
            delta_dtype=torch.float32, path=case.path,
            dataflow=case.dataflow, n=n, gn=-(-n // BN), w_itemsize=4,
            ema_decay=DECAY, budget=case.budget, shard=tshard)
        steps.append(dict(
            ref=lane_dict(jentry), got=lane_dict(tentry), delta=delta,
            mask=mask, matches=matches, ref_delta=np.asarray(jd),
            ref_mask=np.asarray(jm), codes=c,
            ptrs={name: t.data_ptr()
                  for name, t in sa.written_lanes(tentry).items()}))
    return case, ptrs, steps


def test_fused_entry_lanes_bitwise_reference(fused):
    """Every lane and prev_q bitwise the reference's jitted reuse_linear,
    at a batch of 2 and 8 (padded rows) and a K tail."""
    case, _, steps = fused
    for i, step in enumerate(steps):
        assert_lanes_equal(step["got"], step["ref"], f"{case} step {i}")
        np.testing.assert_array_equal(step["got"]["prev_q"], step["codes"])


def test_fused_entry_delta_and_mask_equal_reference(fused):
    """delta [M, K] and the tile mask bitwise the reference's padding
    entry; the match counts are the unchanged codes of each row."""
    case, _, steps = fused
    prev = None
    for step in steps:
        assert tuple(step["delta"].shape) == (case.m, case.k)
        np.testing.assert_array_equal(step["delta"].numpy(), step["ref_delta"])
        np.testing.assert_array_equal(step["mask"].numpy(), step["ref_mask"])
        if prev is not None:
            np.testing.assert_array_equal(
                step["matches"].numpy(),
                (step["codes"] == prev).sum(axis=1).astype(np.float32))
        prev = step["codes"]


def test_fused_entry_writes_the_entry_in_place(fused):
    """prev_q and every lane the call writes keep their tensors (a CUDA
    graph reads them by address)."""
    _, ptrs, steps = fused
    for step in steps:
        assert step["ptrs"] == ptrs


def partial_model(x, prev_q, scale, block_m, block_k):
    """numpy model of the fused kernel's per-tile partials: each real row's
    unchanged codes in the real columns of each tile, from operands read
    as 0 past M and K (the kernel's edge), [M, gk]."""
    m, k = x.shape
    gm, gk = -(-m // block_m), -(-k // block_k)
    xp = np.zeros((gm * block_m, gk * block_k), np.float32)
    pp = np.zeros((gm * block_m, gk * block_k), np.int32)
    xp[:m, :k], pp[:m, :k] = x, prev_q
    q = np.clip(np.rint(xp / np.float32(scale)), -127, 127).astype(np.int32)
    same = q == pp
    real = np.zeros_like(same)
    real[:m, :k] = True
    tiles = (same & real).reshape(gm * block_m, gk, block_k).sum(axis=2)
    return tiles[:m], (same.reshape(gm * block_m, gk, block_k)
                       .sum(axis=2)[:m])


@pytest.mark.parametrize("m,k,bm,bk", [(2, 300, 8, 64), (8, 300, 8, 64),
                                       (12, 320, 8, 64), (8, 3000, 8, 256),
                                       (130, 4100, 128, 256)])
def test_partials_sum_to_the_row_matches(m, k, bm, bk):
    """Σ over tiles of the kernel's partials equals `row_code_matches` over
    the real columns, with a K tail and with padded rows; counting the
    padded columns too (where both sides read 0) would not."""
    rng = np.random.default_rng(m * 7 + k)
    prev = rng.integers(-100, 101, (m, k)).astype(np.int8)
    cur = np.where(rng.random((m, k)) < 0.6, prev,
                   rng.integers(-127, 128, (m, k))).astype(np.int8)
    x = cur.astype(np.float32) * np.float32(SCALE)
    part, with_pad = partial_model(x, prev, SCALE, bm, bk)
    assert part.shape == (m, -(-k // bk))
    want = row_code_matches(torch.from_numpy(cur), torch.from_numpy(prev))
    np.testing.assert_array_equal(part.sum(axis=1).astype(np.float32),
                                  want.numpy())
    if k % bk:
        assert (with_pad.sum(axis=1) > part.sum(axis=1)).all()
