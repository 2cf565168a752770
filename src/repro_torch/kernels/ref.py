"""Plain PyTorch versions of the kernels (the correctness contracts).

Port of ``repro/kernels/ref.py``.  ``decode_attention_ref`` is ported with
its kernel, in a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import strict_fp32

__all__ = ["masked_l2_topk_ref", "BIG", "lowest_id_topk"]

BIG = 3.4e38  # stand-in for +inf that survives arithmetic


def lowest_id_topk(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries per row, equal values in ascending column
    order (``jax.lax.top_k``'s tie rule; ``torch.topk`` does not promise
    it).  Columns beyond the row width come back as (+inf, -1)."""
    vals, idx = torch.sort(d2, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    short = k - vals.shape[1]
    if short > 0:
        b = d2.shape[0]
        vals = torch.cat([vals, d2.new_full((b, short), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_full((b, short), -1)], 1)
    return vals, idx


def masked_l2_topk_ref(
    queries: torch.Tensor,  # (B, d) f32
    corpus: torch.Tensor,   # (N, d) f32
    mask: torch.Tensor,     # (N,) bool / {0,1}
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k by squared L2.  Masked-out -> dist BIG, id -1."""
    strict_fp32()
    q2 = (queries * queries).sum(1, keepdim=True)
    x2 = (corpus * corpus).sum(1)
    d2 = torch.clamp_min(q2 + x2[None, :] - 2.0 * (queries @ corpus.T), 0.0)
    d2 = torch.where(mask.to(torch.bool)[None, :], d2, torch.full_like(d2, BIG))
    d, idx = lowest_id_topk(d2, k)
    empty = d >= BIG
    return d.masked_fill(empty, BIG), idx.masked_fill(empty, -1)
