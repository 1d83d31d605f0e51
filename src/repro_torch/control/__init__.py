"""repro_torch.control — online adaptive control plane for reuse serving.

The port of `repro.control`. Where `repro_torch.sensor` measures and
`repro_torch.tune` fits offline, this package
closes the loop LIVE: a host-side :class:`Controller` runs on a background
cadence inside the serving loop and adapts the reuse policy from the in-cache
counters directly — no JSONL round trip:

* :mod:`controller` — the cadence loop (`Controller.step(engine, cache)`);
* :mod:`retune`     — windowed counter deltas → guardrailed tunables moves,
                      through the SAME harvest model as the offline fitter
                      (`repro_torch.tune.harvest`);
* :mod:`budget`     — `max_active_k` adaptation from the measured
                      `overflow_fallbacks` rate;
* :mod:`admit`      — learned per-session admission predictor
                      (replaces the caller-trusted `Request.predicted_sim`);
* :mod:`report`     — typed decisions + the JSONL decision journal
                      (audit/replay);
* :mod:`replay`     — ``python -m repro_torch.control.replay j.jsonl``:
                      re-applies a journal to a fresh policy state (and,
                      with ``--arch``, a fresh engine) and asserts the
                      reproduced trajectory matches the recorded one;
* :mod:`restore`    — checkpointed ctrl lanes vs the tuned table at a cache
                      restore (`resolve_restored_ctrl`).

Serving entry point: ``python -m repro_torch.launch.serve ... --reuse
--control-every N``.
"""

from repro_torch.control.admit import AdmissionPredictor
from repro_torch.control.budget import adapt_budget
from repro_torch.control.controller import ControlConfig, Controller
from repro_torch.control.report import (
    CONTROL_JOURNAL_SCHEMA_VERSION,
    ControlReport,
    Decision,
    DecisionJournal,
    load_journal,
)
from repro_torch.control.replay import ReplayResult, replay_rows
from repro_torch.control.restore import resolve_restored_ctrl
from repro_torch.control.retune import (
    bounded_tunables,
    snapshot_entry,
    window_layer_records,
    window_record,
)

__all__ = [
    "CONTROL_JOURNAL_SCHEMA_VERSION",
    "AdmissionPredictor",
    "ControlConfig",
    "ControlReport",
    "Controller",
    "Decision",
    "DecisionJournal",
    "ReplayResult",
    "adapt_budget",
    "bounded_tunables",
    "load_journal",
    "replay_rows",
    "resolve_restored_ctrl",
    "snapshot_entry",
    "window_layer_records",
    "window_record",
]
