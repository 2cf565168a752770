"""IVF-PQ index: coarse IVF lists + product-quantized codes + int8 ADC scan.

Port of ``repro/index/pq.py``.  The scan touches only the coarse centroids
(L, d), the per-subspace codebooks (M, n_codes, d/M), the uint8 codes
(N, M) in IVF-sorted order and the id/offset layout, all on the device; the
float32 vectors are read only by the exact re-rank of the top-R ADC
candidates and are charged separately (``rerank_bytes``).  With d = 384
there are M = 48 subspaces of 8 dims and 256 codes each.

ADC: per query, the exact (M, n_codes) query-to-codeword table is built
once and floor-quantized to uint8 (per-subspace base + one global scale), so
a candidate's distance is an integer sum of table entries, which only ever
under-estimates: ``0 <= decoded_distance - adc < M * scale``.  The table is
computed on the host exactly as the reference computes it (f32, difference
form, numpy's summation order), so ``lut8`` is equal bit for bit given the
same codebooks; the sums over candidates run on the device and are exact
integers.

Search is strictly per row: every product that feeds a row's answer is
computed for that row alone, and ties break on composite ``(value bits <<
32) | position`` keys, so a row's result does not depend on its batch.  The
exact re-rank keeps the reference's difference form ``((x - q)^2).sum``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, strict_fp32
from .kmeans import assign, kmeans

__all__ = ["IVFPQIndex"]


def _bits_key(vals: torch.Tensor) -> torch.Tensor:
    """Composite int64 key of non-negative f32 values and their position."""
    return (vals.contiguous().view(torch.int32).to(torch.int64) << 32) | torch.arange(
        vals.shape[0], dtype=torch.int64, device=vals.device)


def _smallest(key: torch.Tensor, kk: int) -> torch.Tensor:
    """Positions of the kk smallest (unique) int64 keys, ascending."""
    return torch.topk(key, min(kk, key.shape[0]), largest=False, sorted=True).indices


class IVFPQIndex:
    """Coarse IVF quantizer + per-subspace k-means codebooks + ADC scan."""

    def __init__(
        self,
        vectors,
        n_lists: Optional[int] = None,
        m: Optional[int] = None,
        n_codes: int = 256,
        seed: int = 0,
        train_sample: int = 16384,
        device=DEFAULT_DEVICE,
    ):
        """``vectors``: (N, d) float32, numpy or a tensor (kept as is when it
        already lies on ``device``, so an engine's corpus is not copied)."""
        self.device = resolve_device(device)
        self.vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        self.n, self.dim = self.vectors.shape
        n = max(self.n, 1)
        self.n_lists = min(n_lists or max(8, int(np.sqrt(n))), n)
        # M subspaces of d/8 dims by default (codes stay uint8, every
        # subspace is non-empty)
        self.m = min(m or max(1, self.dim // 8), max(self.dim, 1))
        self.dsub = int(np.ceil(self.dim / self.m)) if self.dim else 1
        self.n_codes = int(min(n_codes, 256, n))
        self.seed = seed
        self.train_sample = train_sample
        self.built = False

    # ------------------------------------------------------------------
    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad the feature axis to m * dsub (zeros add nothing to L2)."""
        want = self.m * self.dsub
        if x.shape[1] == want:
            return x
        return torch.nn.functional.pad(x, (0, want - x.shape[1]))

    def build(self, iters: int = 6) -> "IVFPQIndex":
        strict_fp32()
        dev = self.device
        if self.n == 0:
            return self.set_state(
                centroids=np.zeros((0, self.dim), np.float32),
                sorted_ids=np.empty(0, np.int32), offsets=np.zeros(1, np.int64),
                codebooks=np.zeros((self.m, 1, self.dsub), np.float32),
                codes=np.empty((0, self.m), np.uint8),
                radius_sq=np.zeros(self.m, np.float32))
        # coarse quantizer: the IVFIndex layout
        c, a = kmeans(self.vectors, self.n_lists, iters=iters, seed=self.seed)
        order = torch.argsort(a, stable=True)
        counts = torch.bincount(a, minlength=self.n_lists).cpu().numpy()
        offsets = np.zeros(self.n_lists + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        # per-subspace codebooks trained on a fixed sample (the reference's draw)
        xp = self._pad(self.vectors)
        rng = np.random.default_rng(self.seed + 17)
        sample = (
            rng.choice(self.n, size=min(self.train_sample, self.n), replace=False)
            if self.n > self.train_sample else np.arange(self.n)
        )
        sample_t = torch.as_tensor(sample, device=dev)
        cbs = torch.zeros((self.m, self.n_codes, self.dsub), device=dev)
        codes = torch.zeros((self.n, self.m), dtype=torch.uint8, device=dev)
        radius_sq = np.zeros(self.m, np.float32)
        for j in range(self.m):
            sub = xp[:, j * self.dsub : (j + 1) * self.dsub]
            cb, _ = kmeans(sub[sample_t].contiguous(), self.n_codes, iters=iters,
                           seed=self.seed + 1 + j)
            cbs[j] = cb
            code_j = assign(sub, cb)
            codes[:, j] = code_j.to(torch.uint8)
            # quantization radius over the whole corpus (the encode/decode
            # round-trip bound)
            radius_sq[j] = float(((sub - cb[code_j]) ** 2).sum(1).max())
        return self.set_state(centroids=c, sorted_ids=order.to(torch.int32),
                              offsets=offsets, codebooks=cbs, codes=codes[order],
                              radius_sq=radius_sq)

    def set_state(self, *, centroids, sorted_ids, offsets, codebooks, codes,
                  radius_sq) -> "IVFPQIndex":
        """Install a built layout: coarse centroids (L, d), IVF-sorted ids
        (N,) and offsets (L+1,), codebooks (M, n_codes, dsub), IVF-sorted
        uint8 codes (N, M) and per-subspace radii (M,).  ``build`` ends here;
        ``repro_torch.carry`` calls it with a reference index's arrays."""
        dev = self.device
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=dev).contiguous()
        self.n_lists = self.centroids.shape[0]
        self.sorted_ids = torch.as_tensor(sorted_ids, device=dev).to(torch.int32)
        self.offsets = np.asarray(torch.as_tensor(offsets).cpu(), np.int64)   # host
        self.codebooks = torch.as_tensor(codebooks, dtype=torch.float32,
                                         device=dev).contiguous()
        self.m, self.n_codes, self.dsub = self.codebooks.shape
        # the host copy the query tables are computed from
        self._codebooks_np = self.codebooks.cpu().numpy()
        self.codes = torch.as_tensor(codes, device=dev).to(torch.uint8).contiguous()
        self.radius_sq = np.asarray(radius_sq, np.float32)
        self._counts = torch.as_tensor(np.diff(self.offsets), device=dev)
        self._starts = torch.as_tensor(self.offsets[:-1], device=dev)
        self._lut_cols = torch.arange(self.m, device=dev, dtype=torch.int64) * self.n_codes
        self.built = True
        return self

    # ------------------------------------------------------------------
    # encode / decode (property-test surface)
    # ------------------------------------------------------------------
    def encode(self, x) -> np.ndarray:
        """(B, d) -> (B, M) uint8 nearest-codeword assignment (first index
        among equal distances)."""
        assert self.built
        xp = self._pad(torch.as_tensor(np.atleast_2d(np.asarray(x, np.float32)),
                                       device=self.device))
        out = torch.zeros((xp.shape[0], self.m), dtype=torch.uint8, device=self.device)
        for j in range(self.m):
            sub = xp[:, j * self.dsub : (j + 1) * self.dsub]
            d2 = ((sub[:, None, :] - self.codebooks[j][None]) ** 2).sum(-1)
            out[:, j] = torch.argmin(d2, dim=1).to(torch.uint8)
        return out.cpu().numpy()

    def decode(self, codes) -> np.ndarray:
        """(B, M) uint8 -> (B, d) reconstructed vectors."""
        assert self.built
        c = torch.as_tensor(np.atleast_2d(np.asarray(codes)), device=self.device).long()
        parts = [self.codebooks[j][c[:, j]] for j in range(self.m)]
        return torch.cat(parts, dim=1)[:, : self.dim].cpu().numpy().astype(np.float32)

    # ------------------------------------------------------------------
    # ADC machinery
    # ------------------------------------------------------------------
    def _lut(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
        """Exact (M, n_codes) query-to-codeword table + its uint8 form, on
        the host, as the reference computes it.  Returns ``(lut8, base (M,),
        scale)`` with ``lut8*scale + base in (lut_f - scale, lut_f]``."""
        qs = np.zeros(self.m * self.dsub, np.float32)
        qs[: self.dim] = np.asarray(q, np.float32).reshape(-1)
        qs = qs.reshape(self.m, self.dsub)
        lut_f = ((self._codebooks_np - qs[:, None, :]) ** 2).sum(-1)   # (M, n_codes)
        base = lut_f.min(axis=1)
        span = float((lut_f - base[:, None]).max())
        scale = max(span / 255.0, 1e-12)
        lut8 = np.minimum(
            np.floor((lut_f - base[:, None]) / scale), 255.0
        ).astype(np.uint8)
        return lut8, base, scale

    def _adc(self, lut8: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
        """Exact int64 table sums for (C, M) codes."""
        lut = torch.as_tensor(lut8.reshape(-1), device=self.device).to(torch.int64)
        return lut[codes.long() + self._lut_cols[None, :]].sum(1)

    def adc_distances(self, q, ids) -> Tuple[np.ndarray, float]:
        """int8-LUT ADC distances for global ``ids`` plus the quantization
        error bound: ``0 <= decoded_exact - adc < bound`` per candidate."""
        assert self.built
        q = np.asarray(q, np.float32).reshape(-1)
        lut8, base, scale = self._lut(q)
        inv = torch.empty_like(self.sorted_ids, dtype=torch.int64)
        inv[self.sorted_ids.long()] = torch.arange(self.n, device=self.device)
        pos = inv[torch.as_tensor(np.asarray(ids, np.int64), device=self.device)]
        acc = self._adc(lut8, self.codes[pos]).cpu().numpy()
        adc = acc.astype(np.float64) * scale + float(base.sum())
        return adc.astype(np.float32), self.m * scale

    # ------------------------------------------------------------------
    def search(
        self,
        queries,
        k: int,
        nprobe: int = 8,
        rerank: int = 64,
        mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Masked ADC top-k with optional exact re-rank of the top-R; host
        (dists (B, k), ids (B, k)), -1/inf padded.

        ``rerank=0`` returns raw ADC distances; ``rerank=R > 0`` rescores the
        R best ADC candidates against the original vectors (distances exact).
        """
        assert self.built
        strict_fp32()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        b = q.shape[0]
        out_d = np.full((b, k), np.inf, np.float32)
        out_i = np.full((b, k), -1, np.int32)
        if self.n == 0:
            return out_d, out_i
        nprobe = min(nprobe, self.n_lists)
        mask_t = (None if mask is None
                  else torch.as_tensor(np.asarray(mask, bool), device=self.device))
        q_t = torch.as_tensor(q, device=self.device)
        for r in range(b):
            d, ids = self._search_one(q[r], q_t[r].clone(), k, nprobe, rerank, mask_t)
            out_d[r, : d.size], out_i[r, : ids.size] = d, ids
        return out_d, out_i

    def _search_one(self, q, q_t, k, nprobe, rerank, mask_t):
        empty = np.empty(0, np.float32), np.empty(0, np.int32)
        # probes: nearest coarse lists, ties broken by list id
        qc = torch.clamp_min(((self.centroids - q_t[None]) ** 2).sum(1), 0.0)
        probes = _smallest(_bits_key(qc), nprobe)
        cnt = self._counts[probes]
        total = int(cnt.sum())
        if total == 0:
            return empty
        # the probed lists' positions in the sorted layout, in probe order
        seg_start = torch.repeat_interleave(self._starts[probes] - (torch.cumsum(cnt, 0) - cnt),
                                            cnt, output_size=total)
        pos = seg_start + torch.arange(total, device=self.device)
        cand_ids = self.sorted_ids[pos]
        if mask_t is not None:
            keep = mask_t[cand_ids.long()]
            pos, cand_ids = pos[keep], cand_ids[keep]
        n_pos = pos.shape[0]
        if n_pos == 0:
            return empty
        # int8 ADC scan over the surviving candidates
        lut8, base, scale = self._lut(q)
        acc = self._adc(lut8, self.codes[pos])
        take = min(max(rerank, k) if rerank > 0 else k, n_pos)
        adc_key = (acc << 32) | torch.arange(n_pos, dtype=torch.int64, device=self.device)
        sel = _smallest(adc_key, take)
        sel_ids = cand_ids[sel]
        if rerank > 0:
            # exact re-rank in the reference's difference form; composite
            # keys keep equal distances in ADC order
            ex = torch.clamp_min(((self.vectors[sel_ids.long()] - q_t[None]) ** 2).sum(1), 0.0)
            order = _smallest(_bits_key(ex), min(k, ex.shape[0]))
            return ex[order].cpu().numpy(), sel_ids[order].cpu().numpy().astype(np.int32)
        adc = (acc[sel].to(torch.float64) * scale + float(base.sum())).to(torch.float32)
        kk = min(k, adc.shape[0])
        return adc[:kk].cpu().numpy(), sel_ids[:kk].cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    def memory_bytes(self) -> int:
        """Scan-resident bytes: codes + codebooks + coarse centroids + id
        layout.  The exact-re-rank vectors are ``rerank_bytes``."""
        assert self.built
        dev_bytes = sum(t.numel() * t.element_size() for t in
                        (self.codes, self.codebooks, self.centroids, self.sorted_ids))
        return int(dev_bytes + self.offsets.nbytes)

    @property
    def rerank_bytes(self) -> int:
        return int(self.vectors.numel() * self.vectors.element_size())
