"""The one traffic generator: a mix is a data file of parameters
(`traffic/<mix>.json`), and this module turns it and the run's seed into
cohorts.

A cohort is the program's lockstep serving unit: `batch` requests prefilled
together at one prompt length, then `decode_steps` decode steps for all of
them (the decode state keeps one length for the whole batch). Cohorts follow
one another at once, a closed loop.

Keys of a mix file:

    batch          requests in a cohort (the decode batch)
    prompt_lens    the prompt lengths; every run of len(prompt_lens)
                   cohorts holds each length once, in an order drawn from
                   the seed, so every seed offers the same work
    decode_steps   decode steps a cohort
    cache_len      the KV extent the decode state is built with
    feed           "greedy": each request is fed its own greedy token of the
                   step before; "anchor": with probability `correlation` it
                   is fed its cohort's anchor token instead (a stream whose
                   consecutive inputs repeat)
    correlation    the anchor's probability (feed "anchor")

Prompt tokens are uniform over the vocabulary in every mix; anchors too,
one a request. Everything a cohort draws comes from
`numpy.random.default_rng([seed, index, ...])`, so cohort i of a seed is
the same in every run and needs no earlier cohort.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KEYS = {"batch", "prompt_lens", "decode_steps", "cache_len", "feed",
        "correlation"}
FEEDS = ("greedy", "anchor")


def check(mix: dict) -> dict:
    """The mix's parameters, refused when a key is missing or unknown."""
    if set(mix) != KEYS:
        raise ValueError(f"traffic keys {sorted(mix)} != {sorted(KEYS)}")
    if mix["feed"] not in FEEDS:
        raise ValueError(f"traffic feed {mix['feed']!r} not in {FEEDS}")
    if max(mix["prompt_lens"]) + mix["decode_steps"] > mix["cache_len"]:
        raise ValueError("a cohort does not fit the KV extent")
    return mix


@dataclasses.dataclass
class Cohort:
    index: int
    prompts: np.ndarray     # [B, S] int32
    anchors: np.ndarray     # [B] int32
    keep: np.ndarray        # [decode_steps, B] bool: fed the anchor

    @property
    def prompt_len(self) -> int:
        return self.prompts.shape[1]

    def feed(self, step: int, greedy: np.ndarray) -> np.ndarray:
        """The tokens [B] fed to decode step `step` (1-based), given the
        greedy tokens [B] the step before served."""
        return np.where(self.keep[step - 1], self.anchors,
                        greedy).astype(np.int32)


def cohort(mix: dict, vocab: int, seed: int, index: int) -> Cohort:
    seed = seed % 2**63
    lens = mix["prompt_lens"]
    order = np.random.default_rng([seed, index // len(lens), 0]).permutation(
        len(lens))
    s = lens[order[index % len(lens)]]
    b = mix["batch"]
    rng = np.random.default_rng([seed, index, 1])
    prompts = rng.integers(0, vocab, (b, s)).astype(np.int32)
    anchors = rng.integers(0, vocab, (b,)).astype(np.int32)
    if mix["feed"] == "anchor":
        keep = rng.random((mix["decode_steps"], b)) < mix["correlation"]
    else:
        keep = np.zeros((mix["decode_steps"], b), dtype=bool)
    return Cohort(index, prompts, anchors, keep)
