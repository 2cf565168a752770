"""Deterministic synthetic token pipeline (shardable, restartable).

Port of ``repro/data/pipeline.py``, copied (numpy only): the same (seed,
step) gives the same batch, bit for bit, in both packages.

Real deployments plug a tokenised corpus in here; the contract the trainer
relies on is: (a) ``batch_at(step)`` is a pure function of (seed, step) so a
restarted/elastically-resized job regenerates identical batches, (b) hosts
can take disjoint shards by slicing the batch dim.

Sequences are Zipf-distributed token ids with a Markov bigram flavour so the
loss actually decreases during the example runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"       # "vision"/"audio" -> adds stub embeddings
    frontend_len: int = 0
    d_model: int = 0

    def batch_at(self, step: int, host_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        # Zipf marginals + deterministic bigram drift -> learnable structure
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks**1.1
        p /= p.sum()
        base = rng.choice(self.vocab_size, size=(b, s + 1), p=p)
        drift = (np.cumsum(base, axis=1) % 7) == 0
        base[:, 1:] = np.where(drift[:, 1:], (base[:, :-1] + 1) % self.vocab_size, base[:, 1:])
        batch = {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }
        if self.frontend == "vision":
            batch["patches"] = rng.normal(
                0, 1, (b, self.frontend_len, self.d_model)
            ).astype(np.float32)
        elif self.frontend == "audio":
            batch["frames"] = rng.normal(
                0, 1, (b, self.frontend_len, self.d_model)
            ).astype(np.float32)
        if host_slice is not None:
            batch = {k: v[host_slice] for k, v in batch.items()}
        return batch
