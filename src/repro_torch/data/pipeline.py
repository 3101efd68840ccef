"""Deterministic synthetic LM data pipeline (own copy of
``repro/data/pipeline.py``, which imports jax but uses only numpy).

Production-shaped: stateless per-step generation keyed by (seed, step) so any
step's batch is reproducible after a restart — the checkpoint stores only the
step counter (the data "cursor"), giving exactly-once sample delivery across
preemptions without data-state files.  Host-sharded feeding: each data-axis
host slice can generate only its shard (``host_slice``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "zipf"        # 'zipf' (skewed, learnable) | 'uniform' | 'markov'


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int,
               host_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Batch for ``step``; tokens[t+1] is the label for tokens[t].

    ``host_slice=(i, n)`` generates rows [i*B/n, (i+1)*B/n) only."""
    rng = _batch_rng(cfg, step)
    B, T, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    if cfg.kind == "uniform":
        seq = rng.integers(0, V, size=(B, T + 1), dtype=np.int64)
    elif cfg.kind == "markov":
        # deterministic affine chain + noise: next = (a*cur + b) % V, learnable
        seq = np.empty((B, T + 1), dtype=np.int64)
        seq[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, T)) < 0.1
        rand = rng.integers(0, V, size=(B, T))
        for t in range(T):
            nxt = (seq[:, t] * 31 + 17) % V
            seq[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    else:  # zipf-distributed unigrams (skewed like natural text)
        u = rng.random((B, T + 1))
        seq = np.minimum((u ** -1.25 - 1).astype(np.int64), V - 1)
        seq = (seq * 2654435761) % V
    tokens = seq[:, :-1].astype(np.int32)
    labels = seq[:, 1:].astype(np.int32)
    if host_slice is not None:
        i, n = host_slice
        rows = slice(i * B // n, (i + 1) * B // n)
        tokens, labels = tokens[rows], labels[rows]
    return {"tokens": tokens, "labels": labels}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  host_slice: Optional[Tuple[int, int]] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, host_slice)
        step += 1
