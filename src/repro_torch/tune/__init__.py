"""repro_torch.tune — trace-driven tuning of the reuse policy.

The port of `repro.tune`. Serving runs record measured per-site harvest
(`--sensor-jsonl`), the fitter turns those traces into per-site
:class:`~repro_torch.core.policy.SiteTunables`, and the table feeds back
into serving via ``--tuned-policy``:

    serve --reuse --sensor-jsonl trace.jsonl                  # record
    python -m repro_torch.tune.fit --trace trace.jsonl \\
        --out tuned.json --pallas-target                       # fit
    serve --reuse --tuned-policy tuned.json                   # exploit

* ``trace``   — schema-validated loader for sensor JSONL output;
* ``harvest`` — the break-even/harvest solver;
* ``fit``     — the offline fitter front door (``python -m
  repro_torch.tune.fit``);
* ``table``   — tuned-table JSON serialization + policy construction.

Traces and tables are the reference's files: either package reads what the
other writes.
"""

from repro_torch.tune.fit import FitConfig, fit_layer, fit_site, fit_trace
from repro_torch.tune.harvest import record_from_sensor, solve_site
from repro_torch.tune.table import (
    TUNED_TABLE_SCHEMA_VERSION,
    TableSchemaError,
    load_table,
    load_tuned_policy,
    save_table,
)
from repro_torch.tune.trace import (
    SiteTraceRecord,
    Trace,
    TraceSchemaError,
    load_trace,
)

__all__ = [
    "FitConfig",
    "SiteTraceRecord",
    "TUNED_TABLE_SCHEMA_VERSION",
    "TableSchemaError",
    "Trace",
    "TraceSchemaError",
    "fit_layer",
    "fit_site",
    "fit_trace",
    "load_table",
    "load_trace",
    "load_tuned_policy",
    "record_from_sensor",
    "save_table",
    "solve_site",
]
