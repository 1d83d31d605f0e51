"""Continuous-batching request scheduler for the serving runtime.

A fixed decode batch of B slots: requests queue, claim a free slot, prefill
into that slot's cache lane, then ride the shared decode step until EOS or
their token limit. The reuse caches are slot-aligned, so a recycled slot's
reuse lane is reset (`reset_slot`): a fresh stream must not delta against the
previous occupant, and the engine's cold start (reuse == quantized dense on
the first step) makes that safe.

Placement is first-free, or, with a lane-similarity hook and a prediction
for the request (its own `predicted_sim`, else the batcher's
`predict_sim_fn`, the learned admission predictor of `repro_torch.control`),
the free slot whose lane history is closest to the prediction.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.obs import events
from repro_torch.obs.trace import span


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: run to max_new_tokens
    # Predicted stream similarity in [0, 1] (a session-level prior). When
    # set, and the batcher has a slot_sim_fn, admission places the request on
    # the free slot whose lane history matches best. Left None, the batcher's
    # `predict_sim_fn` (the learned admission predictor) supplies it.
    predicted_sim: float | None = None
    # Session identity for the learned admission predictor: requests sharing
    # a session share a similarity estimate. None = per-request (rid) keying.
    session: object = None
    # filled by the scheduler
    output: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    telemetry: dict | None = None


def reset_slot(
    reuse_cache: dict | None, slot: int, *, admission=None
) -> dict | None:
    """Zero one slot's reuse lane across all sites, IN PLACE: prev_q,
    prev_out, the per-slot sim_ema lane and the sensor's per-slot hit-rate
    lanes. Returns the same cache.

    `admission` (an AdmissionPredictor, or anything with `.reset_slot(slot)`)
    gets its per-slot occupant state cleared in the same pass, also when
    there is no reuse cache: a new session must not inherit the previous
    occupant's similarity estimate."""
    if admission is not None:
        admission.reset_slot(slot)
    if reuse_cache is None:
        return None
    for entry in reuse_cache.values():
        entry["prev_q"][..., slot, :] = 0
        entry["prev_out"][..., slot, :] = 0
        if entry["sim_ema"].ndim >= 1:
            entry["sim_ema"][..., slot] = 0
        if "sensor" in entry:
            entry["sensor"]["slot_hit_sum"][..., slot] = 0
            entry["sensor"]["slot_steps"][..., slot] = 0
    return reuse_cache


class ContinuousBatcher:
    def __init__(
        self,
        *,
        batch_slots: int,
        prefill_fn: Callable,     # (slot_tokens [1, S], slot) -> first token
        decode_fn: Callable,      # (tokens [B, 1]) -> next tokens [B, 1]
        max_steps: int = 512,
        telemetry_fn: Callable | None = None,  # (slot) -> dict, at retirement
        on_retire: Callable | None = None,     # (Request) -> None
        slot_sim_fn: Callable | None = None,   # (slot) -> lane similarity
        on_step: Callable | None = None,       # (step_idx) -> None, post-decode
        predict_sim_fn: Callable | None = None,  # (Request) -> predicted sim
        on_place: Callable | None = None,      # (Request) -> None, post-admit
    ):
        self.batch_slots = batch_slots
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.max_steps = max_steps
        self.telemetry_fn = telemetry_fn
        self.on_retire = on_retire
        self.slot_sim_fn = slot_sim_fn
        self.on_step = on_step
        self.predict_sim_fn = predict_sim_fn
        self.on_place = on_place
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.free_slots = list(range(batch_slots))
        self.completed: list[Request] = []
        self.stats = {"steps": 0, "prefills": 0, "emitted_tokens": 0,
                      "affinity_placements": 0}
        self._cur: np.ndarray | None = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _pick_slot(self, req: Request) -> int:
        """Slot for an incoming request: first-free, or with a slot_sim_fn
        and a prediction for the request, the free slot whose lane history
        is closest to the prediction (similarity-alike streams on the same
        lanes keep the per-slot sim_ema the policy reads stable)."""
        pred = req.predicted_sim
        if pred is None and self.predict_sim_fn is not None:
            pred = float(self.predict_sim_fn(req))
        if (
            pred is None
            or self.slot_sim_fn is None
            or len(self.free_slots) == 1
        ):
            return self.free_slots.pop()
        slot = min(
            self.free_slots,
            key=lambda s: abs(float(self.slot_sim_fn(s)) - pred),
        )
        self.free_slots.remove(slot)
        self.stats["affinity_placements"] += 1
        return slot

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self._pick_slot(req)
            req.slot = slot
            if self.on_place is not None:
                self.on_place(req)
            # The prefill span (and everything the prefill emits) carries the
            # request/session identity — admission is where a slot's stream
            # changes owner, so this is the correlation boundary.
            with events.context(request=req.rid, session=req.session,
                                slot=slot):
                with span("prefill", slot=slot,
                          prompt_len=int(req.prompt.shape[0])):
                    first = self.prefill_fn(req.prompt[None, :], slot)
            req.output.append(int(first))
            self.active[slot] = req
            self.stats["prefills"] += 1

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        req.done = True
        # telemetry is snapshotted BEFORE the slot is freed (the next
        # occupant's prefill resets its lanes); retirement work is stamped
        # with the departing request's identity
        with events.context(request=req.rid, session=req.session, slot=slot):
            if self.telemetry_fn is not None:
                req.telemetry = self.telemetry_fn(slot)
            self.completed.append(req)
            self.free_slots.append(slot)
            if self.on_retire is not None:
                self.on_retire(req)

    @property
    def pending(self) -> bool:
        """Work remains: requests queued or slots actively decoding."""
        return bool(self.active or self.queue)

    def step_once(self) -> bool:
        """Admit waiting requests and run ONE shared decode step.

        Returns False when there is nothing left to do. An external loop
        (the N-replica harness) interleaves several batchers step by step in
        one process instead of letting each run to completion."""
        if self._cur is None:
            self._cur = np.zeros((self.batch_slots, 1), np.int32)
        self._admit()
        if not self.active and not self.queue:
            return False
        for slot, req in self.active.items():
            self._cur[slot, 0] = req.output[-1]
        # THE serve-step measurement: host launch + device execution, one
        # span per decode step, batch-occupancy tagged. `decode_fn` returns
        # host tokens: their copy back is what waits for the device.
        with span("serve_step", active=len(self.active)):
            nxt = np.asarray(self.decode_fn(self._cur))
        self.stats["steps"] += 1
        if self.on_step is not None:
            self.on_step(self.stats["steps"])
        for slot in list(self.active):
            req = self.active[slot]
            tok = int(nxt[slot, 0])
            req.output.append(tok)
            self.stats["emitted_tokens"] += 1
            if (req.eos_id >= 0 and tok == req.eos_id) or (
                len(req.output) >= req.max_new_tokens
            ):
                self._retire(slot)
        return True

    def run(self) -> list[Request]:
        for _ in range(self.max_steps):
            if not self.step_once():
                break
        return self.completed
