"""Tuned-table loading: versioned JSON -> {site: SiteTunables}.

Reads the document `repro.tune.table.save_table` writes (`--tuned-policy` on
launch/serve.py): schema version, kind, free-form meta, one entry per site.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.core.policy import ReusePolicy, SiteTunables

TUNED_TABLE_SCHEMA_VERSION = 1
TUNED_TABLE_KIND = "reuse_tuned_table"


class TableSchemaError(ValueError):
    pass


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
