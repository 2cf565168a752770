"""Exact (brute-force) KNN with optional predicate masking.

Port of ``repro/index/flat.py``: the ground-truth oracle for recall and the
route ``fused_masked_topk`` takes for k above the kernel's lists.  A plain
matrix product and ``torch.topk``, as the reference left them to XLA.
``torch.topk`` does not promise which of two equal distances comes first,
so ids are compared with the reference up to exact distance ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32

__all__ = ["l2_topk", "chunked_masked_topk", "FlatIndex"]


def _finish(dists: torch.Tensor, idx: torch.Tensor):
    """Ids of +inf (masked-out or missing) slots become -1."""
    return dists, torch.where(torch.isinf(dists), -1, idx).to(torch.int32)


def l2_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by squared L2 distance.

    queries: (B, d), corpus: (N, d), mask: optional (N,) bool — True = passes
    the predicate.  Returns (dists (B,k), idx (B,k)); masked-out entries get
    +inf distance and index -1.
    """
    strict_fp32()
    q2 = (queries * queries).sum(1, keepdim=True)        # (B, 1)
    x2 = (corpus * corpus).sum(1)                         # (N,)
    d2 = torch.clamp_min(q2 + x2[None, :] - 2.0 * (queries @ corpus.T), 0.0)
    if mask is not None:
        d2 = d2.masked_fill(~mask[None, :], float("inf"))
    dists, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return _finish(dists, idx)


def chunked_masked_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming variant: scans the corpus in chunks with a running top-k,
    never materialising the (B, N) distance matrix."""
    strict_fp32()
    n = corpus.shape[0]
    b = queries.shape[0]
    q2 = (queries * queries).sum(1, keepdim=True)
    best_d = queries.new_full((b, k), float("inf"))
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=queries.device)
    for start in range(0, n, chunk):
        x = corpus[start : start + chunk]
        x2 = (x * x).sum(1)
        d2 = torch.clamp_min(q2 + x2[None, :] - 2.0 * (queries @ x.T), 0.0)
        if mask is not None:
            d2 = d2.masked_fill(~mask[None, start : start + chunk], float("inf"))
        ids = torch.arange(start, start + x.shape[0], device=queries.device)
        cat_d = torch.cat([best_d, d2], 1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], 1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    return _finish(best_d, best_i)


class FlatIndex:
    """Thin object wrapper so executors share one index interface; the
    corpus lives on ``device``."""

    def __init__(self, vectors: np.ndarray, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.vectors = torch.as_tensor(
            np.asarray(vectors, np.float32), device=self.device)
        self.n, self.dim = vectors.shape

    def build(self) -> "FlatIndex":
        return self  # nothing to build

    def search(self, queries, k: int, mask=None):
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        m = None if mask is None else torch.as_tensor(np.asarray(mask, bool), device=self.device)
        if self.n * q.shape[0] <= 64_000_000:
            return l2_topk(q, self.vectors, k, m)
        return chunked_masked_topk(q, self.vectors, k, m)
