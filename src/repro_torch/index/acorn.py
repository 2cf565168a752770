"""ACORN-1 baseline (Patel et al., 2024) — predicate-aware graph search.

Port of ``repro/index/acorn.py``.  ACORN builds one predicate-agnostic
proximity graph of fixed degree M and filters neighbours by the predicate
during traversal; ACORN-1 expands to 2-hop neighbourhoods when too few
1-hop neighbours pass.

* ``build`` runs on the device: k-means into ~N/1024 clusters, then for
  each cluster one product of its members against the members of itself and
  its 2 nearest sibling clusters, and ``topk`` of the short edges.  The
  reference loops over every row in Python; at 2.14M rows (2,089 clusters)
  only the per-cluster loop stays.  A quarter of the degree goes to random
  long-range edges, drawn with the reference's numpy seeds, as are the entry
  seeds.
* ``search`` is the reference's host best-first beam search with on-demand
  2-hop expansion, over host copies of the vectors and the graph: its
  recall floors were set on it.
* ``search_torch`` is the reference's fixed-shape ``search_jax`` (a bounded
  beam loop with batched neighbour gathers) on device tensors, all queries
  at once; a query that has finished keeps its state while the others run.
"""
from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32
from .kmeans import kmeans

__all__ = ["AcornIndex"]

_ROW_CHUNK = 4096        # cluster members per distance block in the build


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.ascontiguousarray(x, np.float32)


class AcornIndex:
    def __init__(self, vectors, m: int = 24, seed: int = 0, device=DEFAULT_DEVICE):
        """``vectors``: (N, d) float32, numpy or a tensor; the device copy is
        shared when it already lies on ``device``, and a host copy is kept
        for :meth:`search`."""
        self.device = resolve_device(device)
        self.vectors_dev = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        self.vectors = _host(vectors)
        self.n, self.dim = self.vectors.shape
        self.m = m
        self.seed = seed
        self.built = False

    # ------------------------------------------------------------------
    def build(self) -> "AcornIndex":
        """Approximate degree-M graph via cluster blocking: each point's
        short edges are its nearest neighbours among the members of its own
        and the 2 nearest sibling clusters; the rest of the degree goes to
        random long-range edges (a pure KNN graph is not navigable from a
        far entry)."""
        strict_fp32()
        n, m, dev = self.n, self.m, self.device
        v = self.vectors_dev
        m_rand = max(2, m // 4)      # long-range edges per node
        m_knn = m - m_rand
        k_clusters = max(4, n // 1024)
        cent, asg = kmeans(v, k_clusters, iters=6, seed=self.seed)
        # the 2 nearest other clusters of each cluster (difference form)
        sib = []
        for s in range(0, k_clusters, 64):
            cd = ((cent[s : s + 64, None, :] - cent[None, :, :]) ** 2).sum(-1)
            rows = torch.arange(cd.shape[0], device=dev)
            cd[rows, rows + s] = float("inf")
            sib.append(torch.sort(cd, dim=1, stable=True).indices[:, :2])
        sib = torch.cat(sib).cpu().numpy()                           # (K, 2)
        order = torch.argsort(asg, stable=True)                      # members, ascending ids
        counts = torch.bincount(asg, minlength=k_clusters).cpu().numpy()
        off = np.concatenate([[0], np.cumsum(counts)])
        sq = (v * v).sum(1)
        nbrs = torch.full((n, m), -1, dtype=torch.int32, device=dev)
        for c in range(k_clusters):
            own = order[off[c] : off[c + 1]]
            if own.numel() == 0:
                continue
            cand = torch.cat([own] + [order[off[s] : off[s + 1]] for s in sib[c]])
            take = min(m_knn, cand.numel() - 1)
            if take <= 0:
                continue
            b, b2 = v[cand], sq[cand]
            for s in range(0, own.numel(), _ROW_CHUNK):
                rows = own[s : s + _ROW_CHUNK]
                d2 = sq[rows][:, None] + b2[None, :] - 2.0 * (v[rows] @ b.T)
                # own members come first in cand: exclude self-edges
                r = torch.arange(rows.numel(), device=dev)
                d2[r, r + s] = float("inf")
                sel = torch.topk(d2, take, dim=1, largest=False, sorted=True).indices
                nbrs[rows, :take] = cand[sel].to(torch.int32)
        # random long-range edges (uniform over the corpus), the reference's draw
        rng = np.random.default_rng(self.seed + 1)
        rand = rng.integers(0, n, size=(n, m - m_knn), dtype=np.int64).astype(np.int32)
        nbrs[:, m_knn:] = torch.as_tensor(rand, device=dev)
        # entry seeding: a fixed random sample scanned per query (plays the
        # role of HNSW's upper layers) and the row nearest the mean
        seeds = rng.choice(n, size=min(64, n), replace=False).astype(np.int32)
        mean = v.mean(0)
        d_mean = torch.cat([((v[s : s + 65536] - mean) ** 2).sum(1)
                            for s in range(0, n, 65536)])
        return self.set_state(neighbors=nbrs, seeds=seeds, entry=int(torch.argmin(d_mean)))

    def set_state(self, *, neighbors, seeds, entry: int) -> "AcornIndex":
        """Install a graph: neighbours (N, M) int32 (-1 padded), entry seeds
        and the entry row.  ``build`` ends here; ``repro_torch.carry`` calls
        it with a reference index's arrays."""
        self.neighbors_dev = torch.as_tensor(neighbors, device=self.device).to(torch.int32)
        self.neighbors = self.neighbors_dev.cpu().numpy()
        self.m = self.neighbors.shape[1]
        self.seeds = np.asarray(seeds, np.int32)
        self.entry = int(entry)
        self.built = True
        return self

    # ------------------------------------------------------------------
    def search(
        self,
        queries,
        k: int,
        ef: int = 64,
        mask: Optional[np.ndarray] = None,
        two_hop: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Predicate-aware beam search on the host, one query at a time.
        ``mask`` (N,) bool or None."""
        assert self.built
        q = np.atleast_2d(np.asarray(queries, np.float32))
        b = q.shape[0]
        out_d = np.full((b, k), np.inf, np.float32)
        out_i = np.full((b, k), -1, np.int32)
        for i in range(b):
            d, ids = self._search_one(q[i], k, ef, mask, two_hop)
            out_d[i, : len(ids)] = d
            out_i[i, : len(ids)] = ids
        return out_d, out_i

    def _search_one(self, q, k, ef, mask, two_hop):
        v = self.vectors
        visited = np.zeros(self.n, bool)

        def dist(ids):
            x = v[ids]
            return ((x - q) ** 2).sum(1)

        # entry seeding: best of the fixed seed sample (+ the mean's nearest)
        seed_ids = np.append(self.seeds, self.entry)
        sd = dist(seed_ids)
        entry = int(seed_ids[int(np.argmin(sd))])
        visited[entry] = True
        d0 = float(((v[entry] - q) ** 2).sum())
        # candidate heap (min by distance); result heap (max by distance)
        cand = [(d0, entry)]
        results = []  # (-d, id) of predicate-passing nodes only
        if mask is None or mask[entry]:
            results.append((-d0, entry))

        while cand:
            d, u = heapq.heappop(cand)
            if len(results) >= ef and -results[0][0] < d:
                break
            nb = self.neighbors[u]
            nb = nb[nb >= 0]
            nb = nb[~visited[nb]]
            # ACORN-1: if filtering starves the frontier, expand 2-hop
            if two_hop and mask is not None and nb.size:
                passing = nb[mask[nb]]
                if passing.size < max(1, nb.size // 4):
                    hop2 = self.neighbors[nb].reshape(-1)
                    hop2 = hop2[hop2 >= 0]
                    hop2 = np.unique(hop2[~visited[hop2]])
                    nb = np.unique(np.concatenate([nb, hop2]))
            if nb.size == 0:
                continue
            visited[nb] = True
            dn = dist(nb)
            for dd, nn in zip(dn, nb):
                dd = float(dd)
                worst = -results[0][0] if len(results) >= ef else np.inf
                if dd < worst:
                    heapq.heappush(cand, (dd, int(nn)))
                    if mask is None or mask[nn]:
                        heapq.heappush(results, (-dd, int(nn)))
                        if len(results) > ef:
                            heapq.heappop(results)
        res = sorted([(-nd, i) for nd, i in results])[:k]
        return [r[0] for r in res], [r[1] for r in res]

    # ------------------------------------------------------------------
    def search_torch(self, queries, k: int, ef: int = 64, iters: int = 64,
                     mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fixed-shape beam search on the device: a bounded loop over an
        (ef,) frontier per query with batched neighbour gathers, the
        reference's ``search_jax``.  Returns device (dists (B, k), ids
        (B, k)), -1/inf padded.  Equal values go to the lower position, as
        ``jax.lax.top_k`` breaks them."""
        assert self.built
        strict_fp32()
        dev = self.device
        v, nbrs = self.vectors_dev, self.neighbors_dev.long()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)), device=dev)
        b, m = q.shape[0], nbrs.shape[1]
        mask_t = (torch.ones(self.n, dtype=torch.bool, device=dev) if mask is None
                  else torch.as_tensor(np.asarray(mask, bool), device=dev))
        inf = float("inf")

        def dist(ids):                                     # ids (B, c) -> (B, c)
            x = v[ids.clamp_min(0)]
            return torch.where(ids >= 0, ((x - q[:, None, :]) ** 2).sum(-1),
                               torch.full(ids.shape, inf, device=dev))

        seed_ids = torch.as_tensor(np.append(self.seeds, self.entry).astype(np.int64),
                                   device=dev).expand(b, -1)
        sd = dist(seed_ids)
        best = torch.argmin(sd, dim=1)
        rows = torch.arange(b, device=dev)
        beam_i = torch.full((b, ef), -1, dtype=torch.int64, device=dev)
        beam_d = torch.full((b, ef), inf, device=dev)
        beam_i[:, 0] = seed_ids[rows, best]
        beam_d[:, 0] = sd[rows, best]
        expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
        no_exp = torch.zeros((b, m), dtype=torch.bool, device=dev)
        for _ in range(iters):
            active = (~expanded & torch.isfinite(beam_d)).any(1)
            if not bool(active.any()):
                break
            # the nearest unexpanded beam entry of each query
            u_pos = torch.argmin(torch.where(expanded, inf, beam_d), dim=1)
            u = beam_i[rows, u_pos]
            exp2 = expanded.clone()
            exp2[rows, u_pos] = True
            nb = torch.where(u[:, None] >= 0, nbrs[u.clamp_min(0)], -1)      # (B, M)
            nd = dist(nb)
            # drop ids already in the beam
            dup = (nb[:, :, None] == beam_i[:, None, :]).any(2)
            nd = torch.where(dup, inf, nd)
            cat_i = torch.cat([beam_i, nb], 1)
            cat_d = torch.cat([beam_d, nd], 1)
            pos = torch.sort(cat_d, dim=1, stable=True).indices[:, :ef]
            new_i = torch.gather(cat_i, 1, pos)
            new_d = torch.gather(cat_d, 1, pos)
            new_e = torch.gather(torch.cat([exp2, no_exp], 1), 1, pos)
            keep = active[:, None]
            beam_i = torch.where(keep, new_i, beam_i)
            beam_d = torch.where(keep, new_d, beam_d)
            expanded = torch.where(keep, new_e, expanded)
        ok = (beam_i >= 0) & mask_t[beam_i.clamp_min(0)]
        beam_d = torch.where(ok, beam_d, inf)
        pos = torch.sort(beam_d, dim=1, stable=True).indices[:, :k]
        out_d = torch.gather(beam_d, 1, pos)
        out_i = torch.where(torch.isinf(out_d), -1, torch.gather(beam_i, 1, pos))
        return out_d, out_i.to(torch.int32)
