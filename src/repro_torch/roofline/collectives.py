"""The no-gather check of the sharded serve: one eager decode step must not
move reuse-cache state across shards.

The reference proves it on the compiled step's HLO
(`repro.roofline.hlo_parse.cache_collective_violations`: an all-gather or
all-to-all is a violation only when an operand or result has a cache
leaf's shape; activation collectives pass). The port has no HLO, so it runs
one eager decode step under `torch.profiler` and a dispatch recorder, which
sees every tensor op, the process group's collectives (`c10d.*`) among
them, with its operands' dtypes, shapes and storages. It flags:

* a collective with an operand or result of a cache leaf's signature
  (`repro_torch.dist.shard.cache_shape_signatures`: its global shape and
  one shard's block), or whose storage is a cache leaf's (`storages`, from
  `cache_storages`: a lane of prev_out can share a shape with an output
  panel, never its storage);
* any copy, cat, stack or gather whose input or output has a cache leaf's
  signature: the cache gathered across shards, or one shard's whole lane
  moved;
* collectives the recorder did not see: more collective kernels named by
  the profiler than collectives dispatched (one issued from C++ or an
  extension), whose operands are unknown, as the reference sees the
  operands of every collective in its HLO.

A step's own per-layer, per-shard reads and writes (a [M, N/S] prev_out
lane, say) carry no signature and pass, and so do the placed step's
all-gathers of output panels (one shard a card), which the reference's
GSPMD step also makes.
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


def _is_collective(name: str) -> bool:
    return name.startswith("c10d.")


class _MoveRecorder(TorchDispatchMode):
    """Records (op, [(dtype, shape) of each tensor operand and result]) of
    every data-moving op dispatched while it is active, and of every
    collective also the storages and the bytes of its largest tensor (what
    a card holds after it)."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, list[tuple[str, tuple]]]] = []
        self.collectives: list[tuple[str, list, list[int], int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        collective = _is_collective(name)
        if collective or _is_move(name):
            tensors, ptrs, sizes = [], [], []

            def note(x):
                if isinstance(x, torch.Tensor):
                    tensors.append((str(x.dtype).removeprefix("torch."),
                                    tuple(int(d) for d in x.shape)))
                    ptrs.append(x.untyped_storage().data_ptr())
                    sizes.append(x.numel() * x.element_size())
                elif isinstance(x, (list, tuple)):
                    for y in x:
                        note(y)

            note(list(args))
            note(list((kwargs or {}).values()))
            note(out)
            if collective:
                self.collectives.append((name, tensors, ptrs,
                                         max(sizes, default=0)))
            else:
                self.ops.append((name, tensors))
        return out


def trace_step(fn: Callable[[], object]) -> dict:
    """Run `fn` (one eager decode step) once under `torch.profiler` and the
    move recorder. Returns {"events": op and kernel names the profiler saw,
    "kernels": the device kernels among them, "moves": the recorder's (op,
    operands), "collectives": its (op, operands, storages, bytes) of each
    collective}."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    rec = _MoveRecorder()
    with profile(activities=acts) as prof, torch.no_grad(), rec:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    return {"events": [e.name for e in events],
            # the device's kernels, without the profiler's annotations of
            # the ranges that launched them ("nccl:_all_gather_base")
            "kernels": [e.name for e in events
                        if str(e.device_type).endswith("CUDA")
                        and not getattr(e, "is_user_annotation", False)],
            "moves": rec.ops, "collectives": rec.collectives}


def cache_storages(cache) -> set[int]:
    """The storages of every tensor leaf of a cache (nested dicts)."""
    out: set[int] = set()

    def add(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                add(v)
        elif isinstance(tree, torch.Tensor):
            out.add(tree.untyped_storage().data_ptr())

    add(cache)
    return out


def cache_collective_violations(trace: dict, signatures: set,
                                storages: set[int] | None = None
                                ) -> list[dict]:
    """The events of `trace` (from `trace_step`) that break the no-gather
    invariant: collectives with an operand or result of a cache leaf's
    signature or on a cache leaf's storage (`storages`), and moves with an
    operand of a signature, and collectives the profiler names beyond
    those the recorder saw (`named_collectives`: their operands are
    unknown). Empty when the invariant holds."""
    out = []
    for name, operands, ptrs, _ in trace.get("collectives", []):
        hits = [(dt, dims) for dt, dims in operands
                if (dt, dims) in signatures]
        aliased = bool(storages) and any(p in storages for p in ptrs)
        if hits or aliased:
            out.append({"op": name, "kind": "collective", "operands": hits,
                        "aliases_cache": aliased})
    unseen = named_collectives(trace) - len(trace.get("collectives", []))
    if unseen > 0:
        out.append({"op": ", ".join(sorted(set(_collective_names(trace)))),
                    "kind": "collective", "operands": [], "unseen": unseen,
                    "aliases_cache": False})
    for name, operands in trace["moves"]:
        hits = [(dt, dims) for dt, dims in operands
                if (dt, dims) in signatures]
        if hits:
            out.append({"op": name, "kind": "move", "operands": hits})
    return out


def _collective_names(trace: dict) -> list[str]:
    names = trace["kernels"] if "kernels" in trace else trace["events"]
    return [n for n in names if any(m in n.lower() for m in COLLECTIVE_MARKS)]


def named_collectives(trace: dict) -> int:
    """Collectives the profiler names: its collective kernels on the card
    (NCCL launches one a collective), none on the CPU; for a trace without
    a kernel list, every event so named."""
    return len(_collective_names(trace))


def collective_count(trace: dict) -> int:
    """Collectives in the trace: the recorder's, or the profiler's where it
    names more."""
    return max(len(trace.get("collectives", [])), named_collectives(trace))


def collective_bytes(trace: dict) -> int:
    """Bytes a card holds after the trace's collectives (each one's largest
    tensor: an all-gather's result)."""
    return sum(size for *_, size in trace.get("collectives", []))
