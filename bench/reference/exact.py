"""The plain reference: predicate semantics and the exact masked top-k.

Plain PyTorch over the benchmark's own arrays (the raw ``cat`` and ``num``
columns and the corpus it generated); it imports nothing of the program.

Predicate semantics (the program's ``core/predicates.py``, restated): a
label ``(attr, code)`` holds where ``cat[:, attr] == code``; a range ``(attr,
((lo, hi), ...))`` holds where ``lo <= num[:, attr] < hi`` for some
interval; a predicate holds where all of its labels and ranges hold.

The exact top-k ranks every passing row by its squared L2 distance in
float32 with TF32 off, keeps the ``CAND`` nearest, and ranks those again by
the distance in float64 (ties by row id): float32 rounding moves a distance
by about 1e-6 of ``|q|^2 + |x|^2``, far less than the gap between a row
among the k nearest and the ``CAND``-th, so the float64 top-k is exact.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence, Tuple

import torch

__all__ = ["predicate_mask", "exact_topk", "lower_precision_topk", "distances64", "CAND",
           "BLOCK"]

CAND = 32     # float32 candidates a query keeps for the float64 ranking
BLOCK = 128   # queries ranked at once


def predicate_mask(pred, cat: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the rows that pass ``pred``."""
    labels, ranges = pred
    m = torch.ones(cat.shape[0], dtype=torch.bool, device=cat.device)
    for attr, code in labels:
        m &= cat[:, attr] == code
    for attr, ivs in ranges:
        x = num[:, attr]
        r = torch.zeros_like(m)
        for lo, hi in ivs:
            r |= (x >= lo) & (x < hi)
        m &= r
    return m


@contextlib.contextmanager
def _tf32(on: bool) -> Iterator[None]:
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even):
    what a TF32 product reads of its inputs, for devices without one."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _dist32(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor, tf32: bool) -> torch.Tensor:
    """(B, N) float32 ``|q|^2 + |x|^2 - 2 q.x``, the product in float32 or,
    with ``tf32``, in TF32 (the card's own, or its rounding elsewhere)."""
    qn = (q * q).sum(1)
    if tf32 and q.device.type != "cuda":
        prod = _round_tf32(q) @ _round_tf32(x).T
    else:
        with _tf32(tf32):
            prod = q @ x.T
    return (qn[:, None] + xn[None, :]) - 2.0 * prod


def distances64(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, k) float64 squared distances of rows ``ids`` (-1: +inf)."""
    safe = ids.clamp_min(0).long()
    diff = x[safe].double() - q.double()[:, None, :]
    d = (diff * diff).sum(-1)
    return d.masked_fill(ids < 0, float("inf"))


def exact_topk(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor, masks: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of one block: ``(d64 (B, k), ids (B, k))``, ids -1 and
    +inf past the passing rows.  ``xn`` is ``(x * x).sum(1)`` in float32,
    ``masks`` (B, N) bool."""
    d = _dist32(q, x, xn, tf32=False).masked_fill_(~masks, float("inf"))
    c = min(CAND, x.shape[0])
    dc, cand = torch.topk(d, c, dim=1, largest=False)
    cand = cand.masked_fill(torch.isinf(dc), -1)
    d64 = distances64(q, x, cand)
    # rank by (float64 distance, row id): sort by id, then stably by distance
    by_id = torch.sort(torch.where(cand < 0, x.shape[0], cand), dim=1).indices
    cand, d64 = torch.gather(cand, 1, by_id), torch.gather(d64, 1, by_id)
    order = torch.sort(d64, dim=1, stable=True).indices[:, :k]
    return torch.gather(d64, 1, order), torch.gather(cand, 1, order)


def lower_precision_topk(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor,
                         masks: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control: the reference computed in TF32, put where the program
    is, answering as the program does: ``(dists (B, k) float32, ids (B, k))``."""
    d = _dist32(q, x, xn, tf32=True).masked_fill_(~masks, float("inf"))
    dk, ids = torch.topk(d, min(k, x.shape[0]), dim=1, largest=False)
    ids = ids.masked_fill(torch.isinf(dk), -1)
    return dk.clamp_min(0.0), ids


def blocks(n: int, size: int = BLOCK) -> Sequence[slice]:
    return [slice(s, min(s + size, n)) for s in range(0, n, size)]
