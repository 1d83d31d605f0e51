"""RWKV-6 (Finch): token shift with data-dependent (LoRA) mixing,
data-dependent decay, the WKV recurrence per head, and the channel mix.
Eight reuse sites a layer: r, k, v, g, o of the time mix and k, v, r of the
channel mix; the LoRA products are plain linears."""

from __future__ import annotations

import torch

from bench.reference.rwkv6 import logits  # noqa: F401

BF16, F32 = 2, 4
PORT_KEYS = {"head_size": "ssm_head_dim"}
# the program fixes the LoRA widths in code (the published 1.6B/3B widths;
# the 7B's are 64 and 128): the configuration states what runs
PORT_CONSTANTS = {"time_mix_lora": ("repro_torch.models.ssm", "RWKV_LORA"),
                  "decay_lora": ("repro_torch.models.ssm", "RWKV_DECAY_LORA")}


def make_weights(cfg: dict, g) -> dict:
    """Token-shift mixes uniform in [0, 1), decay bases uniform in
    [-6, -1), bonus N(0, 0.3²), so every term of the block is live."""
    L, d, v, f = cfg["n_layers"], cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    hd, lora, dlora = cfg["head_size"], cfg["time_mix_lora"], cfg["decay_lora"]
    return {
        "embed": g.normal(v, d, std=0.01),
        "blocks": {"rwkv": {
            "norm1": g.norm(L, d),
            "norm2": g.norm(L, d),
            "tmix": {
                "maa_x": g.uniform(L, d, lo=0.0, hi=1.0),
                "maa_wkvrg": g.uniform(L, 5, d, lo=0.0, hi=1.0),
                "tm_w1": g.dense((L,), d, 5 * lora),
                "tm_w2": g.normal(L, 5, lora, d, std=0.01),
                "td_w1": g.dense((L,), d, dlora),
                "td_w2": g.normal(L, dlora, d, std=0.01),
                "decay_base": g.uniform(L, d, lo=-6.0, hi=-1.0),
                "wr": g.dense((L,), d, d),
                "wk": g.dense((L,), d, d),
                "wv": g.dense((L,), d, d),
                "wg": g.dense((L,), d, d),
                "wo": g.dense((L,), d, d),
                "bonus": g.normal(L, d // hd, hd, std=0.3,
                                  dtype=torch.float32),
                "ln_x": g.norm(L, d),
            },
            "cmix": {
                "maa_k": g.uniform(L, d, lo=0.0, hi=1.0),
                "maa_r": g.uniform(L, d, lo=0.0, hi=1.0),
                "wk": g.dense((L,), d, f),
                "wv": g.dense((L,), f, d),
                "wr": g.dense((L,), d, d),
            },
        }},
        "final_norm": g.norm(d),
        "lm_head": g.dense((), d, v),
    }


def site_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    d, f = cfg["d_model"], cfg["d_ff"]
    return ([(f"rwkv_{w}", d, d) for w in ("wr", "wk", "wv", "wg", "wo")]
            + [("rwkv_cmix_wk", d, f), ("rwkv_cmix_wv", f, d),
               ("rwkv_cmix_wr", d, d)])


def step_extra(cfg: dict, rows: int, kv_len: float) -> tuple[float, float]:
    """Every layer's LoRA products (weights read once) and its WKV step
    (the f32 state read and written)."""
    L, d = cfg["n_layers"], cfg["d_model"]
    hd, lora, dlora = cfg["head_size"], cfg["time_mix_lora"], cfg["decay_lora"]
    lora_w = d * 5 * lora + 5 * lora * d + d * dlora + dlora * d
    flops = L * (2.0 * rows * lora_w + 8.0 * rows * d * hd)
    byt = L * (lora_w * BF16 + 2.0 * rows * d * hd * F32)
    return flops, byt
