"""Tuned-table serialization: {site: SiteTunables} ⇄ versioned JSON.

The table file is the contract between the offline fitter and the serving
processes that consume it (`--tuned-policy` on launch/serve.py, `policy=` of
the measured-decode runner): a flat JSON document, one entry per site, plus
a schema version and free-form provenance metadata. `save_table` writes the
file `repro.tune.table.save_table` writes, byte for byte, for equal
tunables; `load_table` reads either package's. Unknown sites in the table
are harmless — `ReusePolicy.resolve` only consults entries for sites the
engine registers.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core.policy import ReusePolicy, SiteTunables

TUNED_TABLE_SCHEMA_VERSION = 1
TUNED_TABLE_KIND = "reuse_tuned_table"


class TableSchemaError(ValueError):
    pass


def save_table(
    path: str,
    tunables: dict[str, SiteTunables],
    *,
    meta: dict[str, Any] | None = None,
) -> None:
    doc = {
        "schema_version": TUNED_TABLE_SCHEMA_VERSION,
        "kind": TUNED_TABLE_KIND,
        "meta": meta or {},
        "sites": {name: t.to_dict() for name, t in sorted(tunables.items())},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def load_table(path: str) -> dict[str, SiteTunables]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != TUNED_TABLE_KIND:
        raise TableSchemaError(f"{path}: not a {TUNED_TABLE_KIND} document")
    ver = doc.get("schema_version")
    if ver != TUNED_TABLE_SCHEMA_VERSION:
        raise TableSchemaError(
            f"{path}: schema_version {ver} != supported "
            f"{TUNED_TABLE_SCHEMA_VERSION}")
    return {name: SiteTunables.from_dict(d) for name, d in doc["sites"].items()}


def load_tuned_policy(
    path: str, *, base: ReusePolicy | None = None
) -> ReusePolicy:
    """A ReusePolicy whose per-site table comes from a tuned-table file."""
    return dataclasses.replace(
        base if base is not None else ReusePolicy(),
        site_tunables=load_table(path),
    )
