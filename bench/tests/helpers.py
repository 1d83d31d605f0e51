"""Tiny cells for the harness's CPU tests: the benchmark's configuration
files cut in depth and width, and a short mix, run through the same code on
the CPU with the program's plain kernels."""

from __future__ import annotations

import json
import pathlib
import time

from bench import cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"

E2E = [{"name": "decode_tok_s", "unit": "tokens/s"},
       {"name": "itl_ms_p95", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]


def tiny_config(name: str) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf.update(n_layers=2, d_model=256, d_ff=512, vocab=1024)
    if conf["reference"] == "dense":
        conf.update(n_heads=4, n_kv_heads=2, head_dim=64)
    return conf


def tiny_mix(feed: str = "anchor") -> dict:
    return {"batch": 2, "prompt_lens": [8, 16], "decode_steps": 12,
            "cache_len": 32, "feed": feed, "correlation": 0.8}


def tiny_spec(name: str, feed: str = "anchor", per_layer=()) -> cell.Spec:
    """A tiny cell whose limits hold the plain kernels to the reference's
    own rounding (the two agree bitwise on the CPU)."""
    units = {m["name"]: m["unit"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    return cell.Spec(f"tiny.{name}", tiny_config(name), tiny_mix(feed), E2E,
                     [{"name": n, "unit": units[n]} for n in per_layer],
                     {"logit_gap_mean": 1e-3, "logit_gap": 1e-2}, 2)


def tiny_run(name: str, *, seed: int = 2**31 + 11, trace: bool = False,
             cohorts: int = 2, feed: str = "anchor", per_layer=(),
             **kw) -> dict:
    """One run of a tiny cell on the CPU; `kw` goes to `cell.run`."""
    return cell.run(tiny_spec(name, feed, per_layer), seed, 60.0, trace,
                    t_start=time.perf_counter(), device="cpu",
                    max_cohorts=cohorts, **kw)
