"""The no-gather check of the sharded serve: one eager decode step must not
move reuse-cache state across shards.

The reference proves it on the compiled step's HLO
(`repro.roofline.hlo_parse.cache_collective_violations`: no all-gather or
all-to-all whose operand has a cache leaf's shape). The port has no HLO, so
it runs one eager decode step under `torch.profiler` and, for the operands'
dtypes and shapes, under a dispatch recorder, and flags two kinds of event:

* any collective, by the name of an op or kernel (`nccl`, `all_gather`,
  `all_to_all`);
* any copy, cat, stack or gather whose input or output has the dtype and
  shape of a cache leaf's signature (`repro_torch.dist.shard.
  cache_shape_signatures`): the cache gathered across shards, or one
  shard's whole lane moved.

A step's own per-layer, per-shard reads and writes (a [M, N/S] prev_out
lane, say) carry no signature and pass.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_MARKS = ("nccl", "all_gather", "all_to_all", "allgather",
                    "alltoall")
# the ops that move data as they are (a copy, a concatenation, a gather)
_MOVES = ("copy", "cat", "stack", "gather", "index_select", "index.Tensor",
          "_to_copy", "clone", "take", "index_put", "scatter")


def _is_move(name: str) -> bool:
    return any(m in name for m in _MOVES)


class _MoveRecorder(TorchDispatchMode):
    """Records (op, [(dtype, shape) of each tensor operand and result]) of
    every data-moving op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, list[tuple[str, tuple]]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if _is_move(name):
            tensors = []

            def note(x):
                if isinstance(x, torch.Tensor):
                    tensors.append((str(x.dtype).removeprefix("torch."),
                                    tuple(int(d) for d in x.shape)))
                elif isinstance(x, (list, tuple)):
                    for y in x:
                        note(y)

            note(list(args))
            note(list((kwargs or {}).values()))
            note(out)
            self.ops.append((name, tensors))
        return out


def trace_step(fn: Callable[[], object]) -> dict:
    """Run `fn` (one eager decode step) once under `torch.profiler` and the
    move recorder. Returns {"events": op and kernel names the profiler saw,
    "moves": the recorder's (op, operands)}."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    rec = _MoveRecorder()
    with profile(activities=acts) as prof, torch.no_grad(), rec:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return {"events": [e.name for e in prof.events()], "moves": rec.ops}


def cache_collective_violations(trace: dict, signatures: set) -> list[dict]:
    """The events of `trace` (from `trace_step`) that break the no-gather
    invariant: collectives by name, and moves with an operand of a cache
    leaf's signature. Empty when the invariant holds."""
    out = []
    for name in sorted(set(trace["events"])):
        if any(m in name.lower() for m in COLLECTIVE_MARKS):
            out.append({"op": name, "kind": "collective"})
    for name, operands in trace["moves"]:
        hits = [(dt, dims) for dt, dims in operands
                if (dt, dims) in signatures]
        if hits:
            out.append({"op": name, "kind": "move", "operands": hits})
    return out


def collective_count(trace: dict) -> int:
    """Collective ops and kernels in the trace (by name)."""
    return sum(1 for name in trace["events"]
               if any(m in name.lower() for m in COLLECTIVE_MARKS))
