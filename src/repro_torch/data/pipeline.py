"""Deterministic synthetic data pipeline with sharded, resumable iteration,
as `repro.data.pipeline` (numpy only; a batch is bitwise the reference's for
the same seed, step and host).

Real deployments swap `SyntheticLMSource` for a tokenized corpus reader; the
contract the trainer depends on is:

  * determinism — batch(step) is a pure function of (seed, step), so restart
    from a checkpoint replays the exact stream (fault tolerance requirement);
  * host sharding — each host materializes only its slice of the global batch
    (`host_slice`), matching the DP sharding of the train step;
  * correlated streams — `correlation` controls how similar consecutive
    samples are, which is what drives the input-similarity experiments
    (the paper's Figs. 3/4: sequence workloads are correlated, ResNet-style
    workloads are not, yet both exhibit code-level similarity after int8).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMSource:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # fraction of token positions copied from the previous sample (input
    # similarity in the *token* domain; activation-level similarity is higher)
    correlation: float = 0.0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Consecutive-sample similarity ~= `correlation`, built statelessly:
        every sample mixes a FIXED anchor sequence (kept w.p. sqrt(c), so two
        consecutive samples agree w.p. c at anchor positions) with fresh
        noise. Stateless => random access (exact replay from checkpoints)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        b, s = self.host_batch, self.seq_len
        tokens = rng.integers(0, self.vocab, size=(b, s), dtype=np.int32)
        if self.correlation > 0.0:
            anchor_rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 10**9, self.host_id])
            )
            anchor = anchor_rng.integers(0, self.vocab, size=(b, s),
                                         dtype=np.int32)
            keep = rng.random((b, s)) < np.sqrt(self.correlation)
            tokens = np.where(keep, anchor, tokens)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1  # masked
        return {"tokens": tokens, "labels": labels}


@dataclasses.dataclass
class SyntheticAudioSource:
    """Frame-embedding source for the hubert stub frontend."""

    d_model: int
    seq_len: int
    global_batch: int
    vocab: int = 504
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        self.host_batch = self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        b, s = self.host_batch, self.seq_len
        # smooth frames: audio-like temporal correlation (high similarity regime)
        drift = rng.normal(size=(b, s, self.d_model)).astype(np.float32)
        embeds = np.cumsum(drift, axis=1) * 0.05
        labels = rng.integers(0, self.vocab, size=(b, s), dtype=np.int32)
        return {"embeds": embeds, "labels": labels}


def make_source(cfg, cell, *, seed=0, correlation=0.0, n_hosts=1, host_id=0):
    if cfg.frontend == "audio":
        return SyntheticAudioSource(
            d_model=cfg.d_model, seq_len=cell.seq_len,
            global_batch=cell.global_batch, vocab=cfg.vocab, seed=seed,
            n_hosts=n_hosts, host_id=host_id,
        )
    return SyntheticLMSource(
        vocab=cfg.vocab, seq_len=cell.seq_len, global_batch=cell.global_batch,
        seed=seed, correlation=correlation, n_hosts=n_hosts, host_id=host_id,
    )
