"""Compressed all-reduces and top-k merges over candidate lists.

Port of ``repro/dist/collectives.py``.

``compressed_psum`` and ``psum_with_error_feedback`` are the reference's
int8 all-reduce-mean over ``torch.distributed`` (a ``group`` in place of
the reference's ``axis_name``; call them from every rank of the group):

    scale_i = max(max|x_i| / 127, 1e-12)      (per rank i)
    q_i     = round(x_i / scale_i)  in [-127, 127], int8
    mean    = (1/n) * sum_i q_i * scale_i

As in the reference, the all-reduce sums the locally dequantised payload
(identical arithmetic; a production collective would move the int8 bytes
and one scale per rank).  ``psum_with_error_feedback`` carries each rank's
rounding residual e_t = c_t - Q(c_t), c_t = g_t + e_{t-1}, into the next
call, so the accumulated means converge to the exact one (EF-SGD).

``merge_topk`` and ``merge_topk_unique`` are copied as host numpy.  Their
inputs are the executors' results, which are host arrays already
(``SearchResult``), and a merge handles at most (B, n_lists * k)
candidates, so a round trip through the device would only add copies.

Both merges order candidates by one int64 composite key whose high word is
the f32 distance's bit pattern (squared-L2 distances are non-negative, so
the bits sort like the floats): ties break by column in ``merge_topk`` and
by global id in ``merge_topk_unique``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["compressed_psum", "psum_with_error_feedback", "merge_topk", "merge_topk_unique"]


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-rank int8 quantisation: (q, scale), x ~= q * scale."""
    scale = torch.clamp_min(x.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _reduced_mean(q: torch.Tensor, scale: torch.Tensor, group=None) -> torch.Tensor:
    deq = q.to(torch.float32) * scale                 # this rank's int8 contribution
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq / dist.get_world_size(group)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantised all-reduce-mean over ``group`` (the default group
    when None).  Error is bounded by the largest rank's quantisation step:
    |out - mean| <= max_i(scale_i) / 2."""
    q, scale = _quantize_int8(x)
    return _reduced_mean(q, scale, group)


def psum_with_error_feedback(g: torch.Tensor, err: torch.Tensor, group=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed all-reduce-mean with a carried quantisation residual.

    Returns ``(mean, new_err)``; pass ``new_err[0]`` back as ``err`` on the
    next call so that repeated reductions converge to the exact mean.  The
    residual keeps the reference's leading singleton (shard) axis."""
    comp = g + err
    q, scale = _quantize_int8(comp)
    new_err = comp - q.to(torch.float32) * scale      # includes clip error
    return _reduced_mean(q, scale, group), new_err[None]


def merge_topk(
    dists: np.ndarray, ids: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard top-k results into a global top-k.

    ``dists``/``ids``: (n_shards, B, k_i) with -1 ids / +inf dists padding
    invalid slots (ids are already global).  Returns (B, k) sorted by
    ascending distance, -1/inf padded; equal distances keep column (shard)
    order.
    """
    d = np.concatenate(list(dists), axis=1).astype(np.float32)   # (B, sum k_i)
    i = np.concatenate(list(ids), axis=1)
    if d.shape[1] < k:                       # fewer candidates than k: pad
        b, pad = d.shape[0], k - d.shape[1]
        d = np.concatenate([d, np.full((b, pad), np.inf, np.float32)], axis=1)
        i = np.concatenate([i, np.full((b, pad), -1, i.dtype)], axis=1)
    d = np.where(i < 0, np.inf, d)
    key = (
        np.ascontiguousarray(d).view(np.int32).astype(np.int64) << 32
    ) | np.arange(d.shape[1], dtype=np.int64)[None, :]
    if d.shape[1] > k:
        part = np.argpartition(key, k - 1, axis=1)[:, :k]
        inner = np.argsort(np.take_along_axis(key, part, axis=1), axis=1)
        order = np.take_along_axis(part, inner, axis=1)
    else:
        order = np.argsort(key, axis=1)[:, :k]
    rows = np.arange(d.shape[0])[:, None]
    out_d, out_i = d[rows, order], i[rows, order]
    out_i = np.where(np.isinf(out_d), -1, out_i).astype(np.int32)
    return out_d, out_i


_PAD_ID = np.int64(np.iinfo(np.int32).max)   # sorts after every real id


def merge_topk_unique(
    dists: np.ndarray, ids: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge candidate lists into a global top-k with de-duplication: the
    per-disjunct DNF union.

    Same (n_lists, B, k_i) -> (B, k) contract as :func:`merge_topk`, but
    the key is (distance bits, global id), so equal distances go to the
    lowest id, as the whole-predicate masked scan breaks them; an exact
    per-clause union therefore reproduces that scan bit for bit.  An id in
    several lists (a row matching two disjuncts) is kept once, at its
    lowest key.
    """
    d = np.concatenate(list(dists), axis=1).astype(np.float32)   # (B, sum k_i)
    i = np.asarray(np.concatenate(list(ids), axis=1))
    if d.shape[1] < k:
        b, pad = d.shape[0], k - d.shape[1]
        d = np.concatenate([d, np.full((b, pad), np.inf, np.float32)], axis=1)
        i = np.concatenate([i, np.full((b, pad), -1, i.dtype)], axis=1)
    d = np.where(i < 0, np.inf, d)
    iid = np.where(i < 0, _PAD_ID, i.astype(np.int64))
    key = (
        np.ascontiguousarray(d).view(np.int32).astype(np.int64) << 32
    ) | iid
    # de-dup: sort each row by (id, key), mark every non-first occurrence of
    # an id, and neutralise those slots before the top-k selection
    order = np.lexsort((key, iid))
    rows = np.arange(d.shape[0])[:, None]
    s_iid = iid[rows, order]
    dup_sorted = np.zeros_like(s_iid, dtype=bool)
    dup_sorted[:, 1:] = (s_iid[:, 1:] == s_iid[:, :-1]) & (s_iid[:, 1:] != _PAD_ID)
    dup = np.zeros_like(dup_sorted)
    dup[rows, order] = dup_sorted
    d = np.where(dup, np.inf, d)
    i = np.where(dup, -1, i)
    key = np.where(dup, np.iinfo(np.int64).max, key)
    if d.shape[1] > k:
        part = np.argpartition(key, k - 1, axis=1)[:, :k]
        inner = np.argsort(np.take_along_axis(key, part, axis=1), axis=1)
        sel = np.take_along_axis(part, inner, axis=1)
    else:
        sel = np.argsort(key, axis=1)[:, :k]
    out_d, out_i = d[rows, sel], i[rows, sel]
    out_i = np.where(np.isinf(out_d), -1, out_i).astype(np.int32)
    return out_d, out_i
