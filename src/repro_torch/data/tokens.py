"""Synthetic token pipeline for the LM architectures.

Deterministic, shardable, host-side generation: each global batch is derived
from (seed, step), so any host can regenerate exactly its shard — which is
what makes checkpoint/restart exactly-once (the loop skips to `step`, no data
state to save) and makes elastic restarts trivial (a new mesh re-derives its
shards).  Sequences follow a Zipf-ish unigram distribution with short-range
repetition structure so the LM loss actually decreases.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / r**alpha
    return p / p.sum()


def token_batch(cfg: TokenPipelineConfig, step: int) -> dict[str, np.ndarray]:
    """Batch for a given step: {'tokens': [B, S+1] int32}. tokens[:, :-1] are
    inputs, tokens[:, 1:] targets."""
    rng = np.random.default_rng((cfg.seed, step))
    p = _zipf_probs(min(cfg.vocab_size, 50_000))
    toks = rng.choice(len(p), size=(cfg.global_batch, cfg.seq_len + 1), p=p)
    # short-range copy structure: with prob .3, token t repeats token t-k
    k = rng.integers(1, 8)
    mask = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.3
    toks[:, k:][mask[:, k:]] = toks[:, :-k][mask[:, k:]]
    return {"tokens": toks.astype(np.int32)}


def token_batches(cfg: TokenPipelineConfig, start_step: int = 0):
    step = start_step
    while True:
        yield token_batch(cfg, step)
        step += 1
