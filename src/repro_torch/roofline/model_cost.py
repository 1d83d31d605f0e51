"""Analytic per-cell roofline model: FLOPs, HBM bytes, collective bytes.

The reference's model (`repro.roofline.model_cost`), ported with its names
and its arithmetic in the same order, priced at the card this package runs
on. All numbers are PER DEVICE. Terms (seconds):
    compute    = flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = coll_bytes / ICI_BW          (ring factor folded in)

Constants: NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU
datasheet: dense BF16 tensor-core peak 989 TFLOP/s (1,979 with sparsity),
HBM3 bandwidth 3.35 TB/s, and NVLink 4 at 900 GB/s aggregate per card, of
which ICI_BW takes one direction, 450 GB/s. ICI_BW keeps the reference's
name for its collective term; here it is the NVLink figure. All three are
datasheet peaks, never measured, so every output of this module is a
datasheet-priced model of a step, not a measurement.

`MeshSpec(dp=1, tp=1)` prices one card. `POD_MESH` and `MULTIPOD_MESH` are
the reference's mesh shapes, kept because `roofline_row` names them.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.specs import SHAPES, ShapeCell, cell_runnable

PEAK_FLOPS = 989e12   # H100 SXM5 dense BF16 tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12      # H100 SXM5 HBM3 bytes/s (datasheet)
ICI_BW = 450e9        # H100 SXM5 NVLink 4, one direction of 900 GB/s (datasheet)
BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int
    tp: int
    pods: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pods


POD_MESH = MeshSpec(dp=16, tp=16, pods=1)
MULTIPOD_MESH = MeshSpec(dp=16, tp=16, pods=2)


@dataclasses.dataclass
class CellCost:
    flops: float = 0.0          # per device
    hbm_bytes: float = 0.0      # per device
    coll_bytes: float = 0.0     # per device (payload; ring factor included)
    notes: dict = dataclasses.field(default_factory=dict)

    def add(self, flops=0.0, hbm=0.0, coll=0.0, tag=None):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        if tag:
            t = self.notes.setdefault(tag, [0.0, 0.0, 0.0])
            t[0] += flops
            t[1] += hbm
            t[2] += coll

    @property
    def compute_s(self):
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self):
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self):
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self):
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self):
        # optimistic full-overlap model: bounded by the slowest resource
        return max(self.compute_s, self.memory_s, self.collective_s)


def _avg_attended(cell_s: int, causal: bool, window: int | None) -> float:
    """Average KV positions attended per query (exact FLOPs accounting)."""
    s = cell_s
    if window is None:
        return (s + 1) / 2 if causal else s
    w = min(window, s)
    # sum_i min(i+1, w) / s
    return (w * (w + 1) / 2 + (s - w) * w) / s


def _attn_flops(cfg, tokens: int, kv_len: float) -> float:
    return 4.0 * tokens * kv_len * cfg.n_heads * cfg.head_dim


def _mlp_flops(cfg, tokens: int) -> float:
    mult = 6.0 if cfg.mlp_kind == "swiglu" else 4.0
    return mult * tokens * cfg.d_model * cfg.d_ff


def _layer_param_bytes(cfg: ModelConfig, mesh: MeshSpec) -> dict[str, float]:
    """Per-device parameter bytes by layer component (TP-sharded)."""
    d, f = cfg.d_model, cfg.d_ff
    tp = mesh.tp
    attn = (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d) * BF16 / tp
    mlp_mult = 3 if cfg.mlp_kind == "swiglu" else 2
    mlp = mlp_mult * d * f * BF16 / tp
    out = {"attn": attn, "mlp": mlp}
    if cfg.n_experts:
        out["experts_all"] = cfg.n_experts * mlp_mult * d * f * BF16 / tp
        out["router"] = d * cfg.n_experts * F32
        if cfg.shared_expert:
            out["shared"] = mlp
    if cfg.ssm_kind == "rwkv6":
        out["rwkv"] = (5 * d * d + d * d + mlp_mult * d * f) * BF16 / tp
    if cfg.ssm_kind == "mamba2":
        di = cfg.d_inner
        out["mamba"] = (d * (2 * di + 2 * cfg.ssm_state + cfg.n_ssm_heads)
                        + di * d) * BF16 / tp
    out["embed"] = cfg.vocab * d * BF16 / tp
    out["head"] = cfg.vocab * d * BF16 / tp if not cfg.tie_embeddings else 0.0
    return out


def _per_layer_forward(cfg: ModelConfig, mesh: MeshSpec, cell_s: int,
                       tokens_loc: int, cost: CellCost, *,
                       kv_len: float | None = None, decode: bool = False):
    """One *average* layer's forward flops/bytes (per device)."""
    tp = mesh.tp
    pb = _layer_param_bytes(cfg, mesh)
    t = tokens_loc
    d = cfg.d_model

    if cfg.ssm_kind == "rwkv6":
        proj_flops = 2 * t * d * (5 * d) / tp          # r,k,v,g,(w lora small)+o
        wkv_flops = 4 * t * d * cfg.ssm_head_dim        # recurrence (VPU)
        cmix_flops = 4 * t * d * cfg.d_ff / tp
        cost.add(flops=proj_flops + wkv_flops + cmix_flops,
                 hbm=pb["rwkv"] + 10 * t * d * BF16, tag="rwkv")
        return

    if cfg.ssm_kind == "mamba2":
        di = cfg.d_inner
        io_flops = 2 * t * d * (2 * di + 2 * cfg.ssm_state + cfg.n_ssm_heads) / tp \
            + 2 * t * di * d / tp
        scan_flops = 5 * t * di * cfg.ssm_state        # recurrence (VPU)
        cost.add(flops=io_flops + scan_flops,
                 hbm=pb["mamba"] + 8 * t * d * BF16, tag="mamba")
        # shared attn block amortized: 1 per hybrid_attn_every layers
        if cfg.hybrid_attn_every:
            frac = 1.0 / cfg.hybrid_attn_every
            _attn_block(cfg, mesh, cell_s, t, cost, kv_len, decode,
                        scale=frac, include_mlp=True)
        return

    # attention + (mlp | moe); local_global averages window sizes
    if cfg.attn_kind == "local_global":
        r = cfg.local_ratio
        _attn_block(cfg, mesh, cell_s, t, cost, kv_len, decode,
                    scale=r / (r + 1), window=cfg.window)
        _attn_block(cfg, mesh, cell_s, t, cost, kv_len, decode,
                    scale=1 / (r + 1), window=None)
    else:
        _attn_block(cfg, mesh, cell_s, t, cost, kv_len, decode,
                    window=cfg.window if cfg.attn_kind == "swa" else None)

    if cfg.n_experts:
        act = cfg.top_k * cfg.capacity_factor
        mult = 6.0 if cfg.mlp_kind == "swiglu" else 4.0
        moe_flops = act * mult * t * d * cfg.d_ff / tp
        moe_flops += 2 * t * d * cfg.n_experts          # router
        # EP/TP: every expert's shard is read once per step (weight traffic
        # is ALL experts / tp, the MoE serving tax)
        hbm = pb["experts_all"] + pb["router"] + 8 * t * d * BF16
        coll = 2 * t * d * BF16  # token all-to-all (dispatch+combine) approx
        if cfg.shared_expert:
            moe_flops += mult * t * d * cfg.d_ff / tp
            hbm += pb["shared"]
        cost.add(flops=moe_flops, hbm=hbm, coll=coll, tag="moe")
    else:
        cost.add(flops=_mlp_flops(cfg, t) / tp,
                 hbm=pb["mlp"] + 6 * t * d * BF16, tag="mlp")


def _attn_block(cfg, mesh, cell_s, t, cost, kv_len, decode,
                *, scale=1.0, window=None, include_mlp=False):
    tp = mesh.tp
    d = cfg.d_model
    pb = _layer_param_bytes(cfg, mesh)
    proj_flops = 2 * t * d * (cfg.q_dim + 2 * cfg.kv_dim) / tp \
        + 2 * t * cfg.q_dim * d / tp
    if decode:
        attended = min(window, kv_len) if window else kv_len
        kv_elt = 1 if cfg.kv_cache_quant else BF16
        kv_heads = cfg.kv_heads_eff
        kv_bytes = 2 * attended * (t) * kv_heads * cfg.head_dim * kv_elt
        # kv heads replicated when < tp (sanitizer) => full kv read per
        # device; kv_head_pad_to makes the head dim divide tp and shard.
        if kv_heads % tp:
            kv_bytes *= 1.0
        else:
            kv_bytes /= tp
        score_flops = _attn_flops(cfg, t, attended) / tp
        cost.add(flops=scale * (proj_flops + score_flops),
                 hbm=scale * (pb["attn"] + kv_bytes + 6 * t * d * BF16),
                 tag="attn")
    else:
        attended = _avg_attended(cell_s, cfg.causal, window)
        score_flops = _attn_flops(cfg, t, attended) / tp
        cost.add(flops=scale * (proj_flops + score_flops),
                 hbm=scale * (pb["attn"] + 8 * t * d * BF16),
                 tag="attn")
    # TP collectives per layer: all-reduce of the block output (row-parallel
    # o/down proj) ~ 2 ops x t x d x 2bytes x ring factor ~2
    cost.add(coll=scale * 2 * 2 * t * d * BF16, tag="attn_tp")
    if include_mlp:
        cost.add(flops=scale * _mlp_flops(cfg, t) / tp,
                 hbm=scale * (pb["mlp"] + 6 * t * d * BF16), tag="shared_mlp")


def cell_cost(cfg: ModelConfig, cell: ShapeCell, mesh: MeshSpec,
              *, reuse_skip_fraction: float = 0.0,
              reuse_covers_experts: bool = False,
              expert_stickiness: float = 0.0) -> CellCost:
    """Per-device roofline terms for one (arch x shape x mesh) cell.

    reuse_skip_fraction > 0 models ReuseSense decode: that fraction of
    weight-tile HBM traffic (and its MACs) on reuse sites is skipped.
    reuse_covers_experts enables the beyond-paper per-(slot, expert) cache
    extension: routed-expert weight streaming also skips, scaled by
    `expert_stickiness` (P[stream keeps its expert across steps], measured
    by the reference's MoE stickiness benchmark) on top of the delta
    harvest.
    """
    cost = CellCost()
    dp = mesh.dp * mesh.pods
    d = cfg.d_model

    if cell.kind == "train":
        tokens_loc = cell.global_batch * cell.seq_len // dp
        # fwd + bwd(2x) + remat re-fwd (1x) on blocks
        block_cost = CellCost()
        _per_layer_forward(cfg, mesh, cell.seq_len, tokens_loc, block_cost)
        mult = 4.0 if cfg.remat else 3.0
        cost.add(flops=cfg.n_layers * mult * block_cost.flops,
                 hbm=cfg.n_layers * mult * block_cost.hbm_bytes,
                 coll=cfg.n_layers * mult * block_cost.coll_bytes,
                 tag="blocks")
        # embed + lm head (fwd+bwd, no remat)
        head_flops = 3 * 2 * tokens_loc * d * cfg.vocab / mesh.tp
        cost.add(flops=head_flops,
                 hbm=3 * cfg.vocab * d * BF16 / mesh.tp, tag="head")
        # optimizer: read params+mu+nu, write params+mu+nu (f32 moments)
        total_param_bytes = (
            sum(v for k, v in _layer_param_bytes(cfg, mesh).items()
                if k not in ("embed", "head")) * cfg.n_layers
            + _layer_param_bytes(cfg, mesh)["embed"]
            + _layer_param_bytes(cfg, mesh)["head"]
        )
        cost.add(hbm=total_param_bytes * (1 + 2 * 2 + 2 * 2),  # p + mu/nu rw
                 tag="optimizer")
        # DP gradient all-reduce (bf16 grads, ring factor 2)
        cost.add(coll=2 * total_param_bytes, tag="dp_allreduce")
        return cost

    if cell.kind == "prefill":
        tokens_loc = cell.global_batch * cell.seq_len // min(dp, cell.global_batch)
        block_cost = CellCost()
        _per_layer_forward(cfg, mesh, cell.seq_len, tokens_loc, block_cost)
        cost.add(flops=cfg.n_layers * block_cost.flops,
                 hbm=cfg.n_layers * block_cost.hbm_bytes,
                 coll=cfg.n_layers * block_cost.coll_bytes, tag="blocks")
        # KV cache write
        kvw = cfg.n_layers * tokens_loc * 2 * cfg.n_kv_heads * cfg.head_dim * BF16
        cost.add(hbm=kvw, tag="kv_write")
        lb = cell.global_batch // min(dp, cell.global_batch)
        cost.add(flops=2 * lb * d * cfg.vocab / mesh.tp, tag="head")
        return cost

    # decode
    b_loc = max(cell.global_batch // dp, 1)
    block_cost = CellCost()
    _per_layer_forward(cfg, mesh, cell.seq_len, b_loc, block_cost,
                       kv_len=cell.seq_len, decode=True)
    f, h, c = (cfg.n_layers * block_cost.flops,
               cfg.n_layers * block_cost.hbm_bytes,
               cfg.n_layers * block_cost.coll_bytes)
    if reuse_skip_fraction > 0.0:
        # ReuseSense: skip that fraction of weight-tile loads + their MACs on
        # the projection GEMMs; KV/activation traffic and delta/cache upkeep
        # remain. Weight share of decode HBM dominates; approximate weight
        # fraction from the param-byte tags.
        wfrac = _decode_weight_fraction(
            cfg, mesh, cell,
            include_experts=reuse_covers_experts,
            expert_stickiness=expert_stickiness,
        )
        f *= (1 - reuse_skip_fraction * wfrac)
        h *= (1 - reuse_skip_fraction * wfrac)
        # delta/cache upkeep: read prev_q + write cur_q (int8) + prev_out rw
        sites_bytes = _reuse_cache_traffic(cfg, mesh, b_loc)
        h += sites_bytes
    cost.add(flops=f, hbm=h, coll=c, tag="blocks")
    cost.add(flops=2 * b_loc * d * cfg.vocab / mesh.tp,
             hbm=cfg.vocab * d * BF16 / mesh.tp, tag="head")
    return cost


def _decode_weight_fraction(cfg, mesh, cell, *, include_experts=False,
                            expert_stickiness=0.0) -> float:
    """Fraction of decode HBM traffic that is reuse-site weight streaming."""
    pb = _layer_param_bytes(cfg, mesh)
    if cfg.ssm_kind == "rwkv6":
        w = pb["rwkv"]
    elif cfg.ssm_kind == "mamba2":
        w = pb.get("mamba", 0.0) + pb["attn"] / max(cfg.hybrid_attn_every, 1)
    elif cfg.n_experts:
        w = pb["attn"] + pb.get("shared", 0.0)   # routed experts not reused
        if include_experts:
            # per-(slot, expert) extension: an expert's tile skips when the
            # dispatched stream kept that expert AND its delta-block is zero
            w = w + pb["experts_all"] * expert_stickiness
    else:
        w = pb["attn"] + pb["mlp"]
    total = CellCost()
    _per_layer_forward(cfg, mesh, cell.seq_len, 1, total,
                       kv_len=cell.seq_len, decode=True)
    return min(w / max(total.hbm_bytes, 1e-9), 1.0)


def _reuse_cache_traffic(cfg, mesh, b_loc) -> float:
    d = cfg.d_model
    per_site_k = {
        "qkv": d, "out": cfg.q_dim, "in": d, "outm": cfg.d_ff,
    }
    # int8 prev/cur (r+w) + f32 prev_out (r+w), summed over generic 4 sites
    bytes_per_layer = sum(
        b_loc * (2 * k + 0) * 1 for k in per_site_k.values()
    ) + b_loc * 4 * d * F32 * 2
    return cfg.n_layers * bytes_per_layer


# ---------------------------------------------------------------------------
# Kernel-level reuse-GEMM cost model
#
# The cell model above prices whole decode steps; a skip-rate sweep of one
# reuse site's [M,K]x[K,N] GEMM needs the same roofline discipline one level
# down: how much work does each execution path perform at a given tile-skip
# rate? Time is modeled as balance-weighted work (flops + bytes x PEAK/BW),
# so the prediction is a RATIO; validate.validate_kernel_sweep compares
# these ratios against a measured sweep. The paths are the reference's XLA
# tiers (f32 operands, materialized gathers), not this package's kernels.
# ---------------------------------------------------------------------------

MACHINE_BALANCE = PEAK_FLOPS / HBM_BW  # flops per byte at the roofline knee


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Work one reuse-GEMM substrate performs at a given skip rate."""

    path: str
    flops: float
    bytes: float

    @property
    def work(self) -> float:
        # time ∝ flops/PEAK + bytes/BW ∝ flops + bytes·BALANCE; ratios of
        # `work` are the model's speedup predictions.
        return self.flops + self.bytes * MACHINE_BALANCE


def reuse_kernel_cost(
    m: int, k: int, n: int, *, path: str, skip: float = 0.0,
    block_m: int = 8, block_k: int = 128, max_active_k: int | None = None,
) -> KernelCost:
    """Flops + HBM bytes for one [M,K]x[K,N] reuse GEMM on `path`.

    Paths mirror the reference's compiled execution tiers (f32 operands):
      dense / kernel / masked — full GEMM work (the masked XLA lowering and
        the full-grid kernel walk every tile; masking saves no traffic on
        that tier).
      compact — shared-K gather GEMM: only the union of active K-blocks is
        gathered; gather MATERIALIZES the selected weight rows (read source
        + write copy), which is exactly why compact loses below break-even.
      ragged — per-M-group budgeted gather: the XLA lowering gathers a
        weight copy PER GROUP, so its weight traffic is gm x budget blocks.
    This package's kernels differ: its ragged kernel reads the active
    blocks in place and its compact path is the plain product, so a
    measured sweep of them need not follow these prices.
    """
    gk = -(-k // block_k)
    gm = -(-m // block_m)
    el = F32
    dense_flops = 2.0 * m * k * n
    dense_bytes = el * (m * k + k * n + 2.0 * m * n)
    if path in ("dense", "dense_gemm", "kernel", "masked", "masked_ref", "ref"):
        return KernelCost(path=path, flops=dense_flops, bytes=dense_bytes)
    occ = min(max(1.0 - skip, 0.0), 1.0)
    if path == "compact":
        ak = occ * gk * block_k  # union of active K-blocks (shared mask)
        flops = 2.0 * m * ak * n
        bytes_ = el * (
            2.0 * ak * n        # gather W rows: read source + materialize
            + 2.0 * m * ak      # gather delta columns: read + materialize
            + 2.0 * m * n       # prev_out read + out write
        )
        return KernelCost(path=path, flops=flops, bytes=bytes_)
    if path in ("ragged", "ragged_xla"):
        if max_active_k is None:
            kb = max(int(math.ceil(occ * gk)), 1)  # budget sized to occupancy
        else:
            kb = int(max_active_k)
        kb = min(max(kb, 1), gk)
        ak = kb * block_k
        flops = 2.0 * m * ak * n  # einsum runs the full budget, masked
        bytes_ = el * (
            2.0 * gm * ak * n   # per-group weight gather: read + materialize
            + 2.0 * m * ak      # per-group delta gather
            + 2.0 * m * n
        )
        return KernelCost(path=path, flops=flops, bytes=bytes_)
    raise ValueError(f"unknown kernel path {path!r}")


def predict_kernel_speedup(
    m: int, k: int, n: int, *, path: str, skip: float,
    block_m: int = 8, block_k: int = 128, max_active_k: int | None = None,
) -> float:
    """Predicted dense_time / path_time ratio (>1 means the path wins)."""
    dense = reuse_kernel_cost(m, k, n, path="dense", block_m=block_m,
                              block_k=block_k)
    pc = reuse_kernel_cost(m, k, n, path=path, skip=skip, block_m=block_m,
                           block_k=block_k, max_active_k=max_active_k)
    return dense.work / max(pc.work, 1e-12)


def predicted_break_even_skip(
    m: int, k: int, n: int, *, path: str = "compact",
    block_m: int = 8, block_k: int = 128, samples: int = 101,
) -> float:
    """Lowest skip rate where `path` matches dense under the work model.

    Same convention as tune.harvest.derive_break_even_skip: 2.0 = the path
    never wins on this shape (gate should demote to dense)."""
    prev_s, prev_m = None, None
    for i in range(samples):
        s = i / (samples - 1)
        margin = predict_kernel_speedup(
            m, k, n, path=path, skip=s, block_m=block_m, block_k=block_k,
        ) - 1.0
        if margin >= 0.0:
            if prev_s is None or margin == prev_m:
                return s
            t = -prev_m / (margin - prev_m)
            return prev_s + t * (s - prev_s)
        prev_s, prev_m = s, margin
    return 2.0


def model_flops_per_step(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6·N·D (dense train) / 6·N_active·D (MoE train); 2·N·D per
    generated/processed token for inference. GLOBAL (all devices)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch


def roofline_row(arch_cfg: ModelConfig, shape: str, mesh_name: str,
                 *, reuse_skip_fraction: float = 0.0) -> dict:
    cell = SHAPES[shape]
    mesh = POD_MESH if mesh_name == "pod" else MULTIPOD_MESH
    ok, why = cell_runnable(arch_cfg.name, shape)
    if not ok:
        return {"arch": arch_cfg.name, "shape": shape, "mesh": mesh_name,
                "skipped": why}
    c = cell_cost(arch_cfg, cell, mesh,
                  reuse_skip_fraction=reuse_skip_fraction)
    mf = model_flops_per_step(arch_cfg, cell)
    hlo_flops_global = c.flops * mesh.n_devices
    return {
        "arch": arch_cfg.name,
        "shape": shape,
        "mesh": mesh_name,
        "compute_s": c.compute_s,
        "memory_s": c.memory_s,
        "collective_s": c.collective_s,
        "dominant": c.dominant,
        "step_s": c.step_s,
        "model_flops": mf,
        "useful_ratio": mf / max(hlo_flops_global, 1e-9),
        "roofline_fraction": (mf / mesh.n_devices / PEAK_FLOPS) / c.step_s,
        "notes": {k: [round(x, 3) for x in v] for k, v in c.notes.items()},
    }
