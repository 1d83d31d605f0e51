"""Serving: the continuous batcher and the serve step, with the reference's
exports (`repro.serve`)."""

from repro_torch.serve.scheduler import ContinuousBatcher, Request, reset_slot
from repro_torch.serve.serve_step import (
    build_reuse_engine,
    decode_step,
    greedy_sample,
    init_serve_state,
    prefill_step,
)

__all__ = [
    "ContinuousBatcher", "Request", "build_reuse_engine", "decode_step",
    "greedy_sample", "init_serve_state", "prefill_step", "reset_slot",
]
