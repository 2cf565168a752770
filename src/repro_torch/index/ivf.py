"""IVF-Flat index — the global index behind the post-filtering executor.

Port of ``repro/index/ivf.py``'s host ``search`` semantics onto device
tensors: contiguous assignment-sorted lists, ragged probe expansion into a
right-padded (B, C) candidate matrix, dot-form distances against
precomputed ``sorted_sq``, and one top-k over the composite
``(distance bits << 32) | candidate position`` key, which makes both the
boundary pick and the order within ties independent of the padded width.

Row independence.  The reference keeps a row's results identical alone and
inside any batch by calling sgemm only at fixed shapes.  cuBLAS may pick
another algorithm per shape, so here every product that feeds a row's
distances is computed for that row alone, at shapes that depend only on
that row: ``|q|^2`` is a length-d dot, the centroid scores one (L, d) @ (d,)
product, and the candidate dots one (C_row, d) @ (d,) product over the
row's gathered candidates.  The query row is copied to its own buffer first
so the operands' alignment never depends on its batch position.  Results
come back to the host at the end of a search: the post-filter executor
evaluates predicates on the host between α-doubling rounds.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32
from ..obs.trace import NULL_TRACER
from .kmeans import kmeans

__all__ = ["IVFIndex"]

_MAX_WORKSPACE = 32_000_000   # (B, C) candidate lanes held at once per search


class IVFIndex:
    def __init__(self, vectors, n_lists: Optional[int] = None, seed: int = 0,
                 device=DEFAULT_DEVICE):
        """``vectors``: (N, d) float32, numpy or a tensor (kept as is when it
        already lies on ``device``, so the engine's corpus is not copied)."""
        self.device = resolve_device(device)
        self.vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        self.n, self.dim = self.vectors.shape
        # clamp to the corpus size: kmeans cannot seed more centroids than
        # points (tiny corpora otherwise crash the build)
        self.n_lists = min(n_lists or max(16, int(np.sqrt(self.n))), self.n)
        self.seed = seed
        self.built = False

    # ------------------------------------------------------------------
    def build(self, iters: int = 8) -> "IVFIndex":
        c, a = kmeans(self.vectors, self.n_lists, iters=iters, seed=self.seed)
        return self.set_layout(c, a)

    def set_layout(self, centroids, assignment) -> "IVFIndex":
        """Install centroids (L, d) and a row -> list assignment (N,), and
        derive the list-sorted layout from them (``build`` does this after
        k-means; ``repro_torch.carry`` with a reference index's state)."""
        strict_fp32()
        dev = self.device
        c = torch.as_tensor(centroids, dtype=torch.float32, device=dev).contiguous()
        a = torch.as_tensor(assignment, device=dev).to(torch.int64)
        self.n_lists = c.shape[0]
        self.centroids = c                                           # (L, d)
        self._c2 = (c * c).sum(1)
        order = torch.argsort(a, stable=True)
        self.sorted_ids = order.to(torch.int32)                      # (N,)
        self.sorted_vecs = self.vectors[order].contiguous()          # (N, d)
        self.sorted_sq = (self.sorted_vecs * self.sorted_vecs).sum(1)
        counts = torch.bincount(a, minlength=self.n_lists).cpu().numpy()
        self.list_counts = counts.astype(np.int64)                   # (L,) host
        self.offsets = np.zeros(self.n_lists + 1, np.int64)          # host
        np.cumsum(counts, out=self.offsets[1:])
        self.max_list = int(counts.max())
        self.built = True
        return self

    # ------------------------------------------------------------------
    def _probes(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """(B, nprobe) nearest lists per row, nearest first, lowest list id
        among equal scores; each row scored on its own."""
        rows = []
        for r in range(q.shape[0]):
            qr = q[r].clone()
            qc = (torch.dot(qr, qr) + self._c2) - 2.0 * (self.centroids @ qr)
            rows.append(torch.sort(qc, stable=True).indices[:nprobe])
        return torch.stack(rows)

    def search(
        self,
        queries,
        k: int,
        nprobe: int = 8,
        mask: Optional[np.ndarray] = None,
        tracer=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns host (dists (B,k), ids (B,k)); unfilled slots have id
        -1/inf.  ``mask`` (N,) restricts results to passing points, applied
        during the scan.  ``tracer`` times the steps under the caller's open
        span: ``h2d`` (the queries to the device, once; ``bytes``), then,
        per chunk of a large batch, ``ivf.probe`` (the probe lists, back on
        the host) and ``ivf.scan`` (the expansion, the dots, the top-k and
        the results back, with an ``h2d`` for the candidates and one for the
        scatter's indices and any mask)."""
        assert self.built
        strict_fp32()
        tr = tracer if tracer is not None else NULL_TRACER
        with tr.span("h2d"):
            q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
            if tr.enabled:
                tr.annotate(bytes=q.numel() * q.element_size())
        return self._search_dev(q, k, min(nprobe, self.n_lists), mask, tr)

    def _search_dev(self, q: torch.Tensor, k: int, nprobe: int,
                    mask: Optional[np.ndarray], tr) -> Tuple[np.ndarray, np.ndarray]:
        """``search`` on queries already on the device."""
        b = q.shape[0]
        worst_c = nprobe * self.max_list
        if b > 1 and b * worst_c > _MAX_WORKSPACE:
            # rows are composition-independent, so chunking the batch is exact
            chunk = max(1, _MAX_WORKSPACE // max(worst_c, 1))
            parts = [self._search_dev(q[s : s + chunk], k, nprobe, mask, tr)
                     for s in range(0, b, chunk)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        from ..kernels.ops import record_dispatch

        t0 = time.perf_counter()
        with tr.span("ivf.probe"):
            probes = self._probes(q, nprobe).cpu().numpy()              # (B, nprobe)
        with tr.span("ivf.scan"):
            out_d = np.full((b, k), np.inf, np.float32)
            out_i = np.full((b, k), -1, np.int32)
            counts = self.list_counts[probes]                           # (B, nprobe)
            totals = counts.sum(1)                                      # (B,)
            c = int(totals.max()) if b else 0
            if c == 0:
                record_dispatch("ivf_search", time.perf_counter() - t0)
                return out_d, out_i
            # ragged probe segments -> flat sorted-row indices, per-row
            # segment order preserved (the reference's repeat/cumsum
            # construction)
            counts_flat = counts.ravel()
            t = int(counts_flat.sum())
            seg_rep = np.repeat(np.arange(counts_flat.size), counts_flat)
            pos_in_seg = np.arange(t) - np.repeat(np.cumsum(counts_flat) - counts_flat,
                                                  counts_flat)
            cand_flat = self.offsets[probes].ravel()[seg_rep] + pos_in_seg
            row_of = np.repeat(np.arange(b), totals)
            pos_in_row = np.arange(t) - np.repeat(np.cumsum(totals) - totals, totals)
            dev = self.device
            with tr.span("h2d"):
                cand = torch.as_tensor(cand_flat, device=dev)
                if tr.enabled:
                    tr.annotate(bytes=cand_flat.nbytes)
            ends = np.cumsum(totals)
            d2_rows = []
            for r in range(b):
                cr = cand[ends[r] - totals[r] : ends[r]]
                qr = q[r].clone()
                dots = self.sorted_vecs[cr] @ qr                        # (C_r,)
                d2_rows.append((self.sorted_sq[cr] + torch.dot(qr, qr)) - 2.0 * dots)
            d2_flat = torch.clamp_min(torch.cat(d2_rows), 0.0)
            ids_flat = self.sorted_ids[cand]
            with tr.span("h2d"):
                host = [row_of, pos_in_row] + ([] if mask is None else [np.asarray(mask, bool)])
                row_t, pos_t, *mask_t = (torch.as_tensor(a, device=dev) for a in host)
                if tr.enabled:
                    tr.annotate(bytes=sum(a.nbytes for a in host))
            if mask_t:
                keep = mask_t[0][ids_flat.long()]
                d2_flat = d2_flat.masked_fill(~keep, float("inf"))
            d2 = torch.full((b, c), float("inf"), device=dev)
            ids = torch.full((b, c), -1, dtype=torch.int32, device=dev)
            d2[row_t, pos_t] = d2_flat
            ids[row_t, pos_t] = ids_flat
            # canonical top-k on (distance bits, candidate position):
            # non-negative f32 bit patterns sort like the floats, so equal
            # distances break by position, whatever the row's padded width
            key = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(
                c, dtype=torch.int64, device=dev)[None, :]
            kk = min(k, c)
            sel = torch.topk(key, kk, dim=1, largest=False, sorted=True).indices
            sd = torch.gather(d2, 1, sel)
            si = torch.gather(ids, 1, sel)
            fin = torch.isfinite(sd)
            sd = sd.masked_fill(~fin, float("inf")).cpu().numpy()
            si = si.masked_fill(~fin, -1).cpu().numpy()
            out_d[:, :kk] = sd
            out_i[:, :kk] = si
            record_dispatch("ivf_search", time.perf_counter() - t0)
        return out_d, out_i
