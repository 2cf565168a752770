"""What decides ``correct``: the program's answers against the reference.

After the window, a sample of the answered queries (drawn from the seed)
is compared with the plain reference at the timed sizes, block by block.
The numbers compared:

* ``invalid_ids`` (limit 0): returned ids out of range, repeated in a row,
  failing the row's predicate, or after a -1; rows whose distances are not
  finite and ascending.
* ``exact_short_rows`` (limit 0): rows planned exact (``pre``/``ipre``)
  with fewer than ``min(k, passing rows)`` ids.
* ``short_share``: the share of compared rows, every plan, with fewer than
  ``min(k, passing rows)`` ids.  The post path may stop short of k after
  its last expansion round, rarely; an answer left out or emptied where
  it is produced reads as a short row on any plan.
* ``dist_err``: the widest gap between a returned distance and the
  float64 distance of its row, over ``|q|^2 + |x|^2`` (every plan).
* ``exact_gap``: over rows planned exact, the widest gap between the
  float64 distance of the program's j-th nearest and the reference's j-th,
  over ``|q|^2 + |x_ref|^2``.

Beside them, not compared: the recall@k of every compared row against the
reference's exact answer (the end-to-end ``recall_at_10``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.exact import blocks, distances64, exact_topk, lower_precision_topk, predicate_mask

__all__ = ["Readings", "compare", "CHECK_QUERIES", "verdict"]

CHECK_QUERIES = 8192     # answered queries a run compares, drawn from the seed
EXACT_PLANS = ("pre", "ipre")


@dataclasses.dataclass
class Readings:
    invalid_ids: int = 0
    exact_short_rows: int = 0
    short_rows: int = 0
    dist_err: float = 0.0
    exact_gap: float = 0.0
    recall_sum: float = 0.0
    recall_rows: int = 0
    rows: int = 0
    exact_rows: int = 0

    @property
    def recall(self) -> Optional[float]:
        return self.recall_sum / self.recall_rows if self.recall_rows else None

    def numbers(self) -> Dict[str, float]:
        return {"invalid_ids": self.invalid_ids, "exact_short_rows": self.exact_short_rows,
                "short_share": self.short_rows / self.rows if self.rows else 0.0,
                "dist_err": self.dist_err, "exact_gap": self.exact_gap}


def _block_readings(r: Readings, q, x, xn, masks, ids, dist, exact, k: int) -> None:
    """Fold one block of answers (host ``ids``/``dist`` (B, k), ``exact``
    (B,) bool) into ``r``."""
    n = x.shape[0]
    dev = x.device
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    dist_t = torch.as_tensor(dist, dtype=torch.float64, device=dev)
    exact_t = torch.as_tensor(exact, dtype=torch.bool, device=dev)
    n_pass = masks.sum(1)
    ref_d, ref_i = exact_topk(q, x, xn, masks, k)
    valid = ids_t >= 0
    in_range = ids_t < n
    ok = valid & in_range
    safe = torch.where(ok, ids_t, 0)
    passes = torch.gather(masks, 1, safe) & ok
    # a valid id after a -1, or an id that is not -1 and not in [0, N)
    after_gap = valid & (torch.cumsum((~valid).int(), 1) > 0)
    bad = (valid & ~passes) | after_gap | (ids_t < -1)
    srt = torch.sort(torch.where(ok, ids_t, -1 - torch.arange(k, device=dev)), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    fin = torch.isfinite(dist_t) | ~ok
    desc = ok[:, 1:] & ok[:, :-1] & (dist_t[:, 1:] < dist_t[:, :-1])
    r.invalid_ids += int(bad.sum() + dup.sum() + (~fin).sum() + desc.sum())
    n_got = ok.sum(1)
    want = torch.clamp(n_pass, max=k)
    short = n_got < want
    r.exact_short_rows += int((exact_t & short).sum())
    r.short_rows += int(short.sum())
    # distances: the program's against float64 on its own rows
    d64 = distances64(q, x, torch.where(passes, ids_t, -1))
    qn = (q.double() * q.double()).sum(1, keepdim=True)
    scale = qn + xn.double()[safe]
    err = torch.where(passes, (dist_t - d64).abs() / scale, 0.0)
    r.dist_err = max(r.dist_err, float(err.max()) if err.numel() else 0.0)
    # exact rows: the j-th nearest returned against the reference's j-th
    mine = torch.sort(d64, dim=1).values
    ref_ok = ref_i >= 0
    both = ref_ok & torch.isfinite(mine) & exact_t[:, None]
    ref_scale = qn + xn.double()[ref_i.clamp_min(0)]
    gap = torch.where(both, (mine - ref_d) / ref_scale, 0.0)
    r.exact_gap = max(r.exact_gap, float(gap.max()) if gap.numel() else 0.0)
    # recall@k against the exact answer
    hit = ((ids_t[:, :, None] == ref_i[:, None, :]) & ref_ok[:, None, :] & passes[:, :, None])
    hits = hit.any(1).sum(1).double()
    has = want > 0
    r.recall_sum += float((hits[has] / want[has].double()).sum())
    r.recall_rows += int(has.sum())
    r.rows += ids_t.shape[0]
    r.exact_rows += int(exact_t.sum())


def compare(x: torch.Tensor, cat: torch.Tensor, num: torch.Tensor, queries: np.ndarray,
            preds: List, ids: np.ndarray, dist: np.ndarray, exact: np.ndarray, k: int,
            control: bool = False) -> Readings:
    """Readings over the compared rows (``queries``/``preds``/``ids``/
    ``dist``/``exact``, one entry per row).  ``control`` replaces the
    program's answers by the reference computed in TF32, every row exact."""
    r = Readings()
    xn = (x * x).sum(1)
    for sl in blocks(len(preds)):
        q = torch.as_tensor(queries[sl], device=x.device)
        rows = preds[sl]
        masks_of = {p: predicate_mask(p, cat, num) for p in dict.fromkeys(rows)}
        masks = torch.stack([masks_of[p] for p in rows])
        if control:
            cd, ci = lower_precision_topk(q, x, xn, masks, k)
            b_ids, b_dist = ci.cpu().numpy(), cd.cpu().numpy()
            b_exact = np.ones(len(rows), bool)
        else:
            b_ids, b_dist, b_exact = ids[sl], dist[sl], exact[sl]
        _block_readings(r, q, x, xn, masks, b_ids, b_dist, b_exact, k)
    return r


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (an exact comparison's limit is 0)."""
    return all(numbers[name] <= limits[name] for name in numbers)
