"""Model families, one module each, found by the `reference` key of a
configuration's file. A family module holds everything of the benchmark
that depends on the architecture:

    logits(params, cfg, tokens, n_prompt, prec)
        the plain reference (from `bench.reference.<family>`)
    make_weights(cfg, draw)
        the weights in the layout the program reads, from a
        `weights.Draw`
    site_shapes(cfg)
        [(site, in features, out features)] of the reuse sites the
        program registers a layer
    step_extra(cfg, rows, kv_len)
        (FLOPs, bytes) a decode step needs beside the reuse sites and the
        head: attention over `kv_len` cached positions, or the recurrence
    PORT_KEYS
        configuration key → the program's `ModelConfig` field it sets,
        where the names differ
    PORT_CONSTANTS
        configuration key → (module, name) of a size the program fixes in
        code; a run whose configuration states another value fails

A new family adds `families/<name>.py` and `reference/<name>.py`; an
unknown name fails the run.
"""

from __future__ import annotations

import importlib
import pathlib
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent


def known() -> list[str]:
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem[0] != "_")


def load(name: str) -> ModuleType:
    """The family module `families/<name>.py`; an unknown name raises."""
    if name not in known():
        raise KeyError(f"unknown model family {name!r}; known: {known()}")
    return importlib.import_module(f"bench.families.{name}")
