"""The compiled serve step: CUDA graphs over static buffers, the counterpart
of the reference's jitted prefill and its dict of jitted, donated decode
variants (`repro.launch.serve`, and the same per replica in
`repro.launch.replicas`).

`CompiledStep` owns the buffers the step reads and writes, which never move:
the token buffer [B, 1] int32, one prompt buffer [B, S] int32 per prompt
length, the decode state and the reuse cache (the step writes both in place,
and advances the state's `len` in place). A variant is one captured graph
with its own output logits, keyed as the reference keys its compiled steps:

  decode   (spec signature, mode signature, shard plan). The spec
           signature is the
           reference's `tuple(sorted(engine.sites.items()))` without the
           budgets: exec paths and tile geometry. A budget reaches only the
           ragged accounting, which reads the engine's budget lanes (device
           scalars written in place), so a budget move replays the graph it
           had. The mode signature is the bytes of every non-pinned site's
           `mode_host`: the port branches on that host mirror
           (`core/reuse_linear.py`) where the reference branches on the
           device lane, so a mode flip is a new operating point here and a
           ctrl write there. A flip back to a known key reuses its graph.
           The shard plan is the engine's model-axis shard count per site
           (`ReuseEngine.shards`, empty unsharded): a sharded step launches
           each shard's kernels, so another plan is another graph.
  prefill  the prompt buffer's shape.

Decode variants are bounded: past `max_decode_variants` live ones, the
least recently used is evicted with its graph, its output and its pool, and
the pool goes back to the card (`torch.cuda.empty_cache`). A key that comes
back after its eviction is captured again. Prefill variants are few (one per
prompt length) and are never evicted. `last_built` says whether the latest
call built its variant (ran the step eagerly and captured it), a step that
takes tens of replays' time: a step clock reads it to leave such steps out.

The first call with a key runs the step eagerly on a side stream (the real
step; it also loads the kernel libraries and lets cuBLAS and the kernels'
shared-memory grants initialise outside the capture), then captures it.
Capture only records, so the caches advance once. Every later call copies
its input into the buffer and replays. Each variant has a private memory
pool: variants replay in any order, and one's logits must not live in
another's blocks. A failed capture raises and nothing falls back to the
eager step; a replay under another key than its graph's raises.

Placed one shard a card (`ReuseEngine.placement`), each rank captures its
own graphs, and the decode graph holds the step's NCCL all-gathers of
output panels: every rank builds and replays the same keys in the same
order (their host decisions come from the same snapshot), so the captured
collectives pair up. NCCL's communicators start lazily, so one collective
runs on the capture stream before the first capture, and the capture uses
that stream, in CUDA's thread-local capture mode: the process group's
watchdog thread queries its CUDA events while this thread captures, which
the global mode forbids to every thread. A capture that fails raises here
too.

Launch accounting: the wrappers count in Python, so a capture's counts are
taken back out and added once per replay (`backend.recorded_launches`,
`backend.count_replay`); `backend.launch_counts()` stays the kernels the
card ran.

With `graphs=False` (the CPU, or `--eager`, the counterpart of
`jax.disable_jit`) the same class runs the step function directly: buffers
and variant bookkeeping are the same, and `captures` counts what would have
been captured.

Under tracing (`obs.trace.enable()`), `decode` and `prefill` each open a
host span (`compiled_step.decode`, `compiled_step.prefill`), and a replay
runs between two timing events (`trace.device_begin` / `device_end`),
resolved into a device record later, with no sync. With marks asked for
(`trace.set_marks`), decode runs a graph captured with the per-site marks
(`trace.capture_marks`), keyed with the extra component `MARKED`; the
unmarked graph, its key and its launch counts are the ones an untraced
serve runs. Without graphs only the host spans are recorded.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ReuseEngine
from repro_torch.kernels import backend
from repro_torch.obs import trace
from repro_torch.serve.serve_step import decode_step, prefill_step


@dataclasses.dataclass
class Variant:
    key: tuple
    graph: Any                      # torch.cuda.CUDAGraph; None: runs directly
    out: torch.Tensor | None        # the graph's output logits
    launches: collections.Counter   # kernel launches one replay runs
    seconds: float = 0.0            # host time of the capture
    pool_bytes: int = 0             # device memory the capture reserved
    marks: list | None = None       # the graph's timing marks (traced)


# Live decode variants kept before the least recently used is evicted. A
# quarantine and its re-admission move a lane to basic and back: the cap
# keeps the healthy key, the quarantined one and two more alive. On the
# controller's closed loop no evicted key came back, and the cap held
# qwen3-32b's pools (8 layers, ~694 MB a variant) to 2.8 GB (PERF.md §6).
MAX_DECODE_VARIANTS = 4

# the decode key's last component when the graph holds the per-site marks
MARKED = "marked"


class CompiledStep:
    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        state: dict,
        *,
        batch: int,
        engine: ReuseEngine | None = None,
        rcache: dict | None = None,
        graphs: bool,
        log: Callable[[str], None] | None = None,
        max_decode_variants: int = MAX_DECODE_VARIANTS,
    ):
        self.params, self.cfg = params, cfg
        self.state, self.engine, self.rcache = state, engine, rcache
        self.device = state["len"].device
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.graphs = graphs
        self.log = log or (lambda msg: None)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.prompts: dict[tuple, torch.Tensor] = {}
        # live variants, least recently used first
        self.variants: collections.OrderedDict[tuple, Variant] = (
            collections.OrderedDict())
        if max_decode_variants < 1:
            raise ValueError("max_decode_variants must be at least 1")
        self.max_decode_variants = max_decode_variants
        self.evictions = 0
        self.last_built = False
        # (kind, capture seconds, pool bytes) of every variant built,
        # evicted ones included
        self.built: list[tuple[str, float, int]] = []
        self._side = torch.cuda.Stream(self.device) if graphs else None
        self._collectives_ready = False

    # ------------------------------------------------------------- the keys

    def spec_signature(self) -> tuple:
        if self.engine is None:
            return ()
        return tuple(sorted(
            (name, dataclasses.replace(spec, max_active_k=None))
            for name, spec in self.engine.sites.items()))

    def mode_signature(self) -> tuple:
        if self.engine is None or self.rcache is None:
            return ()
        return tuple((name, self.rcache[name]["mode_host"].tobytes())
                     for name, spec in sorted(self.engine.sites.items())
                     if spec.mode not in ("reuse", "basic"))

    def shard_plan(self) -> tuple:
        if self.engine is None:
            return ()
        return tuple(sorted(self.engine.shards.items()))

    def decode_key(self, marked: bool = False) -> tuple:
        """The decode variant's key; `marked`: the variant whose graph holds
        the per-site timing marks (traced, on the card)."""
        key = ("decode", self.spec_signature(), self.mode_signature(),
               self.shard_plan())
        return key + (MARKED,) if marked else key

    # ------------------------------------------- the functions a graph holds

    def run_prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """One prefill of the prompt buffer `prompt` into the static state;
        returns the last-token logits [B, 1, V]."""
        logits, new = prefill_step(self.params, self.cfg, prompt, self.state)
        self.state["len"].copy_(new["len"])
        return logits

    def run_decode(self) -> torch.Tensor:
        """One decode step of the token buffer on the static state and reuse
        cache; returns the logits [B, 1, V]."""
        logits, new, _ = decode_step(
            self.params, self.cfg, self.tokens, self.state,
            engine=self.engine, reuse_cache=self.rcache)
        self.state["len"].copy_(new["len"])
        return logits

    # ------------------------------------------------------------ the calls

    @torch.no_grad()
    def prefill(self, tokens) -> torch.Tensor:
        """Prompt tokens [B, S] (host array or tensor) into the caches.
        Returns the last-token logits, valid until the next call."""
        with trace.span("compiled_step.prefill") as sp:
            shape = tuple(tokens.shape)
            buf = self.prompts.get(shape)
            if buf is None:
                buf = self.prompts[shape] = torch.zeros(
                    shape, dtype=torch.int32, device=self.device)
            buf.copy_(torch.as_tensor(tokens))
            return self._call(("prefill", shape),
                              lambda: self.run_prefill(buf), sp)

    @torch.no_grad()
    def decode(self, tokens) -> torch.Tensor:
        """Tokens [B, 1] (host array or tensor) through one decode step.
        Returns the logits, valid until the next call."""
        with trace.span("compiled_step.decode") as sp:
            self.tokens.copy_(torch.as_tensor(tokens))
            return self.decode_call(self.run_decode, sp,
                                    marked=self.graphs and trace.marking())

    def decode_call(self, fn: Callable[[], torch.Tensor], sp=None, *,
                    marked: bool = False) -> torch.Tensor:
        """`fn` as one decode step: the budget lanes synced, then the variant
        of the current decode key replayed, or built on its first call. A
        caller that steps its own function over the engine's cache (a single
        site, say) keys it as the serve's decode is keyed. `sp`: a traced
        caller's host span, under which the replay is timed; `marked`: the
        variant whose graph holds the per-site marks."""
        if self.engine is not None:
            self.engine.sync_budgets()
        return self._call(self.decode_key(marked), fn, sp)

    def _call(self, key: tuple, fn: Callable[[], torch.Tensor],
              sp=None) -> torch.Tensor:
        """`sp`: the traced call's host span, whose replay is timed."""
        v = self.variants.get(key)
        self.last_built = v is None
        if v is None:
            if key[0] == "decode":
                self._make_room()
            return self._build(key, fn)
        self.variants.move_to_end(key)
        if v.graph is None:
            return fn()
        if sp is None or not trace.is_enabled():
            return self.replay(v, key)
        return self._traced_replay(v, key, sp)

    @property
    def captures(self) -> int:
        """Variants built (captured, or run directly), evicted ones
        included."""
        return len(self.built)

    def live_decode(self) -> int:
        return sum(1 for k in self.variants if k[0] == "decode")

    def _make_room(self) -> None:
        """Evict least recently used decode variants until one more fits
        under the cap; their pools go back to the card."""
        freed = False
        while self.live_decode() >= self.max_decode_variants:
            key = next(k for k in self.variants if k[0] == "decode")
            v = self.variants.pop(key)
            if v.graph is not None:
                v.graph.reset()
                freed = True
            v.graph = v.out = None
            self.evictions += 1
            self.log(f"compiled step: evicted the least recently used decode "
                     f"variant (pool {v.pool_bytes / 1e6:.1f} MB; evictions: "
                     f"{self.evictions})")
        if freed:
            gc.collect()
            torch.cuda.empty_cache()

    def replay(self, v: Variant, key: tuple) -> torch.Tensor:
        if v.key != key:
            raise RuntimeError(f"{key[0]} step: replaying a graph captured "
                               "under another key")
        v.graph.replay()
        backend.count_replay(v.launches)
        return v.out

    def _traced_replay(self, v: Variant, key: tuple, sp) -> torch.Tensor:
        """`replay` between the two timing events of a device record under
        the host span `sp`, the earlier replays resolved first."""
        trace.before_replay(v.marks)
        start = trace.device_begin(self.device)
        out = self.replay(v, key)
        trace.device_end(self.device, f"{sp.name}.replay", sp.span_id, start,
                         v.marks)
        return out

    def _build(self, key: tuple, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        kind = key[0]
        if not self.graphs:
            self.built.append((kind, 0.0, 0))
            self.variants[key] = Variant(key, None, None, collections.Counter())
            self.log(f"compiled step: {kind} variant {self._n_built(kind)} "
                     f"runs directly on {self.device} (captures: "
                     f"{self.captures})")
            return fn()
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = fn()  # the real step, and the warm-up of the capture
        cur.wait_stream(self._side)
        placement = getattr(self.engine, "placement", None)
        capture = {}
        if placement is not None:
            capture.update(stream=self._side,
                           capture_error_mode="thread_local")
            if not self._collectives_ready:
                # the communicators up before any capture records them
                with torch.cuda.stream(self._side):
                    placement.all_gather(torch.zeros(1, device=self.device))
                self._collectives_ready = True
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        marking = (trace.capture_marks() if key[-1] == MARKED
                   else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with backend.recorded_launches() as rec, torch.cuda.graph(
                    graph, **capture), marking as marks:
                gout = fn()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the {kind} step "
                               "failed") from e
        seconds = time.perf_counter() - t0
        pool = torch.cuda.memory_reserved(self.device) - before
        self.built.append((kind, seconds, pool))
        self.variants[key] = Variant(key, graph, gout, rec, seconds, pool,
                                     marks)
        self.log(f"compiled step: captured {kind} variant "
                 f"{self._n_built(kind)} in {seconds:.3f} s, pool "
                 f"{pool / 1e6:.1f} MB, {sum(rec.values())} kernel launches "
                 f"(captures: {self.captures})")
        return out

    def release(self) -> None:
        """Drop every variant and reset its graph (a placed step's graphs
        hold NCCL work, which must be released before the process group
        is destroyed)."""
        for v in self.variants.values():
            if v.graph is not None:
                v.graph.reset()
            v.graph = v.out = None
        self.variants.clear()

    def _n_built(self, kind: str) -> int:
        return sum(1 for k, _, _ in self.built if k == kind)

    def summary(self) -> dict:
        """Variants built by kind, captures, capture seconds and pool bytes
        (evicted variants included); live decode variants against the cap,
        evictions and the pools of the live variants."""
        return {"variants": len(self.built),
                "decode": self._n_built("decode"),
                "prefill": self._n_built("prefill"),
                "captures": self.captures,
                "capture_s": sum(sec for _, sec, _ in self.built),
                "pool_bytes": sum(pool for _, _, pool in self.built),
                "live_decode": self.live_decode(),
                "decode_cap": self.max_decode_variants,
                "evictions": self.evictions,
                "live_pool_bytes": sum(v.pool_bytes
                                       for v in self.variants.values()),
                "graphs": self.graphs}


def summary_line(s: dict) -> str:
    how = ("CUDA graphs" if s["graphs"]
           else "run directly, no CUDA graph")
    return (f"compiled step ({how}): {s['variants']} variants ({s['decode']} "
            f"decode, {s['prefill']} prefill), {s['captures']} captures, "
            f"capture {s['capture_s']:.3f} s, pools "
            f"{s['pool_bytes'] / 1e6:.1f} MB; live {s['live_decode']} decode "
            f"variants (cap {s['decode_cap']}), {s['evictions']} evictions, "
            f"live pools {s['live_pool_bytes'] / 1e6:.1f} MB")
