"""Lloyd k-means on the device (used by the IVF build).

Port of ``repro/index/kmeans.py``.  Assignment is a chunked distance product
with ``argmin`` (first index wins ties); the update sums each cluster's
points over a contiguous slice of the assignment-sorted corpus, so the sums
run in the same order on every run.  ``index_add_`` would be the natural
segment sum, but on CUDA it adds with atomics in an order that changes
between runs, and two builds must give the same centroids.  Empty clusters
are re-seeded to the points farthest from their centroid, as in the
reference.  The init is numpy-seeded, so it is the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import strict_fp32

__all__ = ["kmeans", "assign"]

CHUNK = 131072   # points per distance block


def assign(x: torch.Tensor, centroids: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Nearest-centroid assignment (int64), chunked over points."""
    strict_fp32()
    c2 = (centroids * centroids).sum(1)
    parts = []
    for s in range(0, x.shape[0], chunk):
        xc = x[s : s + chunk]
        d2 = (xc * xc).sum(1, keepdim=True) + c2[None, :] - 2.0 * (xc @ centroids.T)
        parts.append(torch.argmin(d2, dim=1))
    return torch.cat(parts) if parts else x.new_zeros(0, dtype=torch.int64)


def _segment_sums(x: torch.Tensor, a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (counts, sums) in a fixed order: sort by cluster (stable)
    and reduce each contiguous run."""
    counts = torch.bincount(a, minlength=k)
    order = torch.argsort(a, stable=True)
    xs = x[order]
    sums = x.new_zeros((k, x.shape[1]))
    bounds = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    for c in range(k):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        if hi > lo:
            sums[c] = xs[lo:hi].sum(0)
    return counts.to(x.dtype), sums


def _lloyd_iter(x: torch.Tensor, centroids: torch.Tensor, k: int):
    a = assign(x, centroids)
    counts, sums = _segment_sums(x, a, k)
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    empty = counts < 1.0
    if bool(empty.any()):
        # re-seed empty clusters with the points farthest from their centroid
        d_own = torch.cat([((x[s : s + CHUNK] - new_c[a[s : s + CHUNK]]) ** 2).sum(1)
                           for s in range(0, x.shape[0], CHUNK)])
        far = torch.sort(d_own, descending=True, stable=True).indices[:k]
        new_c = torch.where(empty[:, None], x[far], new_c)
    return new_c, a


def kmeans(
    x: torch.Tensor, k: int, iters: int = 10, seed: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centroids (k, d), assignment (n,) int64) on ``x``'s device."""
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.choice(x.shape[0], size=k, replace=False), device=x.device)
    c = x[pick]
    a = None
    for _ in range(iters):
        c, a = _lloyd_iter(x, c, k)
    return c, a
