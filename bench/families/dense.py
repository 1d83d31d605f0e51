"""The dense decoder (nemotron-4-15b's block): pre-norm GQA attention with
RoPE, a squared-ReLU or swiglu MLP, an untied head. Four reuse sites a
layer: attn_qkv, attn_out, mlp_in and mlp_out."""

from __future__ import annotations

from bench.reference.dense import logits  # noqa: F401

BF16 = 2
PORT_KEYS: dict = {}
PORT_CONSTANTS: dict = {}


def _widths(cfg: dict) -> tuple[int, int, int]:
    """(query width, key/value width, MLP input projection width)."""
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    fi = 2 * cfg["d_ff"] if cfg["mlp_kind"] == "swiglu" else cfg["d_ff"]
    return q, kv, fi


def make_weights(cfg: dict, g) -> dict:
    L, d, v, f = cfg["n_layers"], cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    q, kv, fi = _widths(cfg)
    return {
        "embed": g.normal(v, d, std=0.01),
        "blocks": {
            "attn": {"wqkv": g.dense((L,), d, q + 2 * kv),
                     "wo": g.dense((L,), q, d), "norm": g.norm(L, d)},
            "mlp": {"wi": g.dense((L,), d, fi), "wo": g.dense((L,), f, d),
                    "norm": g.norm(L, d)},
        },
        "final_norm": g.norm(d),
        "lm_head": g.dense((), d, v),
    }


def site_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    d, f = cfg["d_model"], cfg["d_ff"]
    q, kv, fi = _widths(cfg)
    return [("attn_qkv", d, q + 2 * kv), ("attn_out", q, d),
            ("mlp_in", d, fi), ("mlp_out", f, d)]


def step_extra(cfg: dict, rows: int, kv_len: float) -> tuple[float, float]:
    """Attention over `kv_len` cached positions in every layer: QKᵀ and PV,
    and the cached keys and values read."""
    L, nh, kvh, hd = (cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"])
    flops = L * 4.0 * rows * nh * hd * kv_len
    byt = L * 2.0 * rows * kv_len * kvh * hd * BF16
    return flops, byt
