"""Live-corpus mutation layer: append segment + packed tombstones.

Port of ``repro/core/corpus.py``.  Everything above this module (stats,
attribute indexes, ANN backends, executors) is built once over a frozen
array of rows; ``LiveCorpus`` lets the engine take writes anyway:

* **deletes** set a bit in a packed uint32 tombstone bitmap
  (``repro_torch.filter.bitmap`` word layout, tail bits clear), composed
  out of every candidate mask at search time;
* **upserts** append rows to a side segment that is scanned exactly and
  merged into every result base part first.  Upserting an existing id
  tombstones the old row and appends the new version under a fresh handle;
* **row handles** are stable: base rows keep ``[0, base_n)``, segment rows
  get ``base_n, base_n + 1, ...`` in insertion order, and ``compacted()``
  folds live rows in handle order, so the handle -> position map is
  monotone and exact searches tie-break alike before and after compaction.

Tombstones, handles, attributes and ``state_tree()`` stay host numpy, as
in the reference.  The segment's vectors live only on ``device``, in a
buffer that doubles its capacity when an upsert outgrows it, so a query
scans them where they are instead of copying the segment from the host;
``seg_vectors()`` copies them back for the host readers (``compacted``,
``state_tree``, resharding).
``assign_new`` is one device product of the fresh rows against the IVF
centroids.  Every mutation bumps ``generation``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32

# repro_torch.filter is imported inside the methods: its compiler imports
# core.predicates, so a module-level import here would cycle through
# repro_torch.core's package init, as in the reference

__all__ = ["LiveCorpus", "CompactionPolicy"]


@dataclasses.dataclass
class CompactionPolicy:
    """When churn crosses any threshold, the engine folds segment +
    tombstones into a rebuilt index (``FilteredANNEngine.maybe_compact``)."""

    max_tombstone_frac: float = 0.20   # dead fraction of all rows
    max_segment_frac: float = 0.20     # segment rows / base rows
    max_list_drift: float = 1.75       # IVF max-list imbalance vs build time

    def due(self, tombstone_frac: float, segment_frac: float,
            list_drift: float = 1.0) -> bool:
        return (tombstone_frac >= self.max_tombstone_frac
                or segment_frac >= self.max_segment_frac
                or list_drift >= self.max_list_drift)


def _pad_words(words: np.ndarray, nw: int) -> np.ndarray:
    return np.pad(words, (0, nw - words.size)) if words.size < nw else words


class LiveCorpus:
    """Mutable view over a frozen base corpus: base + segment + tombstones.

    ``vectors`` is the host (N, d) base corpus (read only by
    :meth:`compacted`); the segment's rows go to ``device``."""

    def __init__(self, vectors: np.ndarray, cat: np.ndarray, num: np.ndarray,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.base_vectors = np.asarray(vectors, np.float32)
        self.base_cat = np.asarray(cat)
        self.base_num = np.asarray(num)
        self.base_n = int(self.base_vectors.shape[0])
        self.dim = int(self.base_vectors.shape[1])
        self._seg_c: List[np.ndarray] = []
        self._seg_m: List[np.ndarray] = []
        self._seg_dev = torch.empty((0, self.dim), dtype=torch.float32, device=self.device)
        self.seg_n = 0
        from ..filter.bitmap import empty_words

        self.tomb = empty_words(self.base_n)    # packed, grows with the segment
        self.n_deleted = 0
        self.generation = 0
        # incremental coarse assignment of segment rows (filled by assign_new)
        self.seg_assign = np.empty(0, np.int32)
        self._cache: dict = {}                  # memoised concat views / masks

    # ------------------------------------------------------------------
    @property
    def n_total(self) -> int:
        return self.base_n + self.seg_n

    @property
    def live_count(self) -> int:
        return self.n_total - self.n_deleted

    @property
    def tombstone_frac(self) -> float:
        return self.n_deleted / self.n_total if self.n_total else 0.0

    @property
    def segment_frac(self) -> float:
        return self.seg_n / self.base_n if self.base_n else 0.0

    @property
    def dirty(self) -> bool:
        """True once any mutation happened: queries then take the
        tombstone/segment-composing path."""
        return self.seg_n > 0 or self.n_deleted > 0

    # ------------------------------------------------------------------
    def seg_vectors(self) -> np.ndarray:
        """The segment's vectors on the host, copied from the device buffer
        (the one copy of them) and memoised until the next mutation."""
        if "sv" not in self._cache:
            self._cache["sv"] = self.seg_vectors_dev().cpu().numpy().copy()
        return self._cache["sv"]

    def seg_vectors_dev(self) -> torch.Tensor:
        """The segment's vectors on the device: a view of the buffer's
        first ``seg_n`` rows."""
        return self._seg_dev[: self.seg_n]

    def seg_cat(self) -> np.ndarray:
        if "sc" not in self._cache:
            self._cache["sc"] = np.concatenate(self._seg_c) if self._seg_c else self.base_cat[:0]
        return self._cache["sc"]

    def seg_num(self) -> np.ndarray:
        if "sm" not in self._cache:
            self._cache["sm"] = np.concatenate(self._seg_m) if self._seg_m else self.base_num[:0]
        return self._cache["sm"]

    def alive_words(self) -> np.ndarray:
        """Packed bitmap of live rows over ``n_total`` (NOT tombstoned)."""
        from ..filter.bitmap import full_words, word_andnot

        if "aw" not in self._cache:
            self._cache["aw"] = word_andnot(full_words(self.n_total), self.tomb, self.n_total)
        return self._cache["aw"]

    def alive_mask(self) -> np.ndarray:
        """(n_total,) bool mask of live rows, memoised until the next
        mutation."""
        from ..filter.bitmap import expand_words

        if "am" not in self._cache:
            self._cache["am"] = expand_words(self.alive_words(), self.n_total)
        return self._cache["am"]

    def is_deleted(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return (self.tomb[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1 == 1

    def row_attrs(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(cat rows, num rows) for any mix of base and segment handles."""
        ids = np.asarray(ids, np.int64)
        in_base = ids < self.base_n
        cat = np.empty((ids.size,) + self.base_cat.shape[1:], self.base_cat.dtype)
        num = np.empty((ids.size,) + self.base_num.shape[1:], self.base_num.dtype)
        cat[in_base] = self.base_cat[ids[in_base]]
        num[in_base] = self.base_num[ids[in_base]]
        if (~in_base).any():
            cat[~in_base] = self.seg_cat()[ids[~in_base] - self.base_n]
            num[~in_base] = self.seg_num()[ids[~in_base] - self.base_n]
        return cat, num

    # ------------------------------------------------------------------
    def _append_dev(self, v: np.ndarray) -> None:
        """Copy new segment rows behind the old ones on the device, doubling
        the buffer when they do not fit."""
        need = self.seg_n + v.shape[0]
        if need > self._seg_dev.shape[0]:
            grown = torch.empty((max(need, 2 * self._seg_dev.shape[0]), self.dim),
                                dtype=torch.float32, device=self.device)
            grown[: self.seg_n] = self._seg_dev[: self.seg_n]
            self._seg_dev = grown
        self._seg_dev[self.seg_n : need] = torch.as_tensor(v, device=self.device)

    def upsert(self, vectors: np.ndarray, cat: np.ndarray, num: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append rows; returns their new handles.  ``ids`` (optional, one
        per row) are existing handles being replaced: they are tombstoned
        first, and handles are never reused."""
        v = np.ascontiguousarray(np.atleast_2d(np.asarray(vectors, np.float32)))
        c = np.atleast_2d(np.asarray(cat))
        m = np.atleast_2d(np.asarray(num))
        rows = v.shape[0]
        if not (c.shape[0] == rows and m.shape[0] == rows):
            raise ValueError("vectors/cat/num row counts disagree")
        if ids is not None:
            self.delete(ids, _bump=False)
        handles = np.arange(self.n_total, self.n_total + rows, dtype=np.int64)
        self._append_dev(v)
        self._seg_c.append(c)
        self._seg_m.append(m)
        self.seg_n += rows
        from ..filter.bitmap import n_words

        self.tomb = _pad_words(self.tomb, n_words(self.n_total))
        self.generation += 1
        self._cache.clear()
        return handles

    def delete(self, ids: np.ndarray, _bump: bool = True) -> np.ndarray:
        """Tombstone handles; idempotent.  Returns the handles that were
        live before this call (the newly dead)."""
        ids = np.unique(np.asarray(ids, np.int64))
        if ids.size and (ids[0] < 0 or ids[-1] >= self.n_total):
            raise IndexError(f"delete ids out of range [0, {self.n_total})")
        fresh = ids[~self.is_deleted(ids)] if ids.size else ids
        if fresh.size:
            np.bitwise_or.at(self.tomb, fresh >> 5,
                             np.uint32(1) << (fresh & 31).astype(np.uint32))
            self.n_deleted += int(fresh.size)
            self._cache.clear()
        if _bump:
            self.generation += 1
        return fresh

    # ------------------------------------------------------------------
    def assign_new(self, centroids: torch.Tensor) -> np.ndarray:
        """Incremental IVF coarse assignment: segment rows not yet assigned
        get their nearest centroid (one device product), earlier
        assignments are kept.  Returns the full (seg_n,) assignment."""
        done = self.seg_assign.size
        if done < self.seg_n:
            strict_fp32()
            fresh = self._seg_dev[done : self.seg_n]
            c = torch.as_tensor(centroids, dtype=torch.float32, device=self.device)
            d2 = ((fresh * fresh).sum(1)[:, None] - 2.0 * (fresh @ c.T)
                  + (c * c).sum(1)[None, :])
            self.seg_assign = np.concatenate(
                [self.seg_assign, d2.argmin(1).to(torch.int32).cpu().numpy()])
        return self.seg_assign

    # ------------------------------------------------------------------
    def compacted(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fold segment + tombstones: live rows in handle order.

        Returns host ``(vectors, cat, num, id_map)`` where ``id_map[handle]``
        is the row's position in the folded arrays, or -1 for tombstoned
        handles; the map is monotone over live handles."""
        keep = np.nonzero(self.alive_mask())[0]
        vectors = np.concatenate([self.base_vectors, self.seg_vectors()])[keep]
        if self.seg_n:
            cat = np.concatenate([self.base_cat, self.seg_cat()])[keep]
            num = np.concatenate([self.base_num, self.seg_num()])[keep]
        else:
            cat, num = self.base_cat[keep], self.base_num[keep]
        id_map = np.full(self.n_total, -1, np.int64)
        id_map[keep] = np.arange(keep.size)
        return np.ascontiguousarray(vectors), cat, num, id_map

    def state_tree(self) -> dict:
        """Array-only snapshot of the mutable state: the reference's keys
        and dtypes, host numpy."""
        return {
            "base_n": np.asarray(self.base_n, np.int64),
            "generation": np.asarray(self.generation, np.int64),
            "tomb": self.tomb.copy(),
            "seg_vectors": self.seg_vectors().copy(),
            "seg_cat": self.seg_cat().copy(),
            "seg_num": self.seg_num().copy(),
        }
