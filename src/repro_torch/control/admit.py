"""Learned admission predictor — per-session similarity from retirement data.

The port of `repro.control.admit`, whole (host Python).

Slot-affinity placement without it trusts a caller-provided
``Request.predicted_sim`` (the serve's synthetic prior under `--affinity`).
This estimator replaces it with a *learned* per-session prediction fit from the
one ground-truth signal the runtime already produces: the per-slot hit-rate
snapshot (`Request.telemetry`) taken at retirement.

State model — three clearly-separated kinds, because they have different
lifetimes:

* **session estimates** (`sessions`) — EMA of retired hit rates keyed by the
  request's session; survive across requests of the same session. A session
  never seen before predicts the population EMA (`global_est`).
* **per-slot occupant state** (the `slot_session` binding) — belongs to the
  CURRENT occupant only; retirement telemetry is attributed through it.
  `reset_slot` (called by the scheduler on slot recycle) clears it: a new
  session must not inherit the previous occupant's similarity estimate, and
  telemetry arriving after a recycle must not be attributed to the departed
  session.
* **lane character** (`lane_character`) — the last RETIRED stream's hit rate
  per slot, used as the lane-side signal for affinity placement (matching
  serve.py's historical lane_sim semantics). Deliberately survives recycling:
  it describes the lane's policy history, not any live session.
"""

from __future__ import annotations

from typing import Any


def _session_key(req: Any) -> Any:
    session = getattr(req, "session", None)
    return session if session is not None else req.rid


class AdmissionPredictor:
    """Per-session stream-similarity estimator fed by retirement telemetry."""

    def __init__(self, *, decay: float = 0.5, prior: float = 0.35,
                 max_sessions: int = 4096):
        self.decay = decay
        self.prior = prior
        self.max_sessions = max_sessions
        self.global_est = prior              # population EMA (cold fallback)
        # least-recently-updated eviction at max_sessions: session-less
        # one-shot requests are keyed by rid (never looked up again), so an
        # unbounded store would grow with total requests served
        self.sessions: dict[Any, float] = {}
        self.slot_session: dict[int, Any] = {}
        self.lane_character: dict[int, float] = {}
        self.observations = 0
        self.rejected_observations = 0  # forged/non-finite telemetry dropped

    # ------------------------------------------------------------- prediction
    def predict(self, req: Any) -> float:
        """Predicted stream similarity for a request — its session's learned
        estimate, else the population estimate. The ContinuousBatcher's
        `predict_sim_fn` hook."""
        return self.sessions.get(_session_key(req), self.global_est)

    def slot_affinity(self, slot: int) -> float:
        """Lane-side affinity signal: the last retired stream's hit rate.
        The ContinuousBatcher's `slot_sim_fn` hook."""
        return self.lane_character.get(slot, 0.0)

    # --------------------------------------------------------------- learning
    def on_placed(self, req: Any) -> None:
        """Bind a slot to its new occupant's session (scheduler `on_place`
        hook, called at admission)."""
        self.slot_session[req.slot] = _session_key(req)

    def observe_retirement(self, req: Any) -> None:
        """Fold one retired request's telemetry into its session estimate.

        Attribution goes through the slot binding when one exists, so
        telemetry can never be credited to a session that already left the
        slot (reset_slot clears the binding on recycle).

        Telemetry is UNTRUSTED input (it crosses the scheduler boundary and
        the guard plane's lying-telemetry scenario forges it): non-finite
        hit rates are dropped entirely — one NaN folded into the EMAs would
        poison every future prediction irreversibly — and finite values are
        clamped to the [0, 1] range a hit rate can actually take. The slot
        binding is still consumed on a dropped observation, so forged
        telemetry can't leave a stale attribution behind."""
        import math

        t = req.telemetry or {}
        if int(t.get("steps", 0)) <= 0:
            return
        hit = float(t.get("hit_rate", 0.0))
        if not math.isfinite(hit):
            self.slot_session.pop(req.slot, None)
            self.rejected_observations += 1
            return
        hit = min(max(hit, 0.0), 1.0)
        key = self.slot_session.pop(req.slot, _session_key(req))
        prev = self.sessions.pop(key, self.global_est)
        while len(self.sessions) >= self.max_sessions:
            del self.sessions[next(iter(self.sessions))]  # oldest update
        self.sessions[key] = (1.0 - self.decay) * prev + self.decay * hit
        self.global_est = (1.0 - self.decay) * self.global_est + self.decay * hit
        self.lane_character[req.slot] = hit
        self.observations += 1

    # ---------------------------------------------------------------- recycle
    def reset_slot(self, slot: int) -> None:
        """Slot recycle: drop the occupant binding so the next stream starts
        from its own session prior and late telemetry can't be attributed to
        the departed session. Lane character is intentionally retained (see
        module docstring)."""
        self.slot_session.pop(slot, None)

    # -------------------------------------------------------------- reporting
    def stats(self) -> dict[str, Any]:
        return {
            "global_est": self.global_est,
            "n_sessions": len(self.sessions),
            "observations": self.observations,
            "rejected_observations": self.rejected_observations,
        }
