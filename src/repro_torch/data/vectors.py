"""Synthetic stand-ins for the paper's four datasets (Table 1).

The public datasets (ArXiv/Wolt via Qdrant, GloVe-200, SIFT-1M via
ann-benchmarks) are not downloadable in this offline container; these
generators match their dimensionality and metadata *shape*, with realistic
structure:

* vectors: Gaussian mixtures (clustered, like real embeddings), cluster ids
  correlated with categorical metadata (filters correlate with geometry in
  real filtered-ANN workloads);
* categorical attributes: Zipf-distributed codes;
* numeric attributes: lognormal ("price"-like) and Gaussian-mixture
  ("year"-like) marginals, partially correlated with cluster id.

Scale is configurable; benchmark default is reduced (CPU container), the
paper-scale row counts remain selectable with ``scale="full"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["VectorDataset", "make_dataset", "DATASETS"]


@dataclasses.dataclass
class VectorDataset:
    name: str
    vectors: np.ndarray     # (N, d) float32
    cat: np.ndarray         # (N, A_cat) int32 codes (-1 = missing)
    num: np.ndarray         # (N, A_num) float32
    filter_kinds: Tuple[str, ...]   # query kinds used in the paper's workload

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


# name -> (paper_n, dim, filter kinds)   [paper Table 1]
DATASETS: Dict[str, Tuple[int, int, Tuple[str, ...]]] = {
    "arxiv": (2_140_000, 384, ("mixed", "label", "range")),
    "wolt": (1_720_000, 512, ("range",)),
    "glove200": (1_180_000, 200, ("range",)),
    "sift": (1_000_000, 128, ("range",)),
}

_REDUCED_N = {
    "arxiv": 120_000,
    "wolt": 100_000,
    "glove200": 100_000,
    "sift": 100_000,
}


def _mixture_vectors(
    rng: np.random.Generator, n: int, d: int, n_clusters: int
) -> Tuple[np.ndarray, np.ndarray]:
    centers = rng.normal(0, 1.0, size=(n_clusters, d)).astype(np.float32)
    weights = rng.dirichlet(np.full(n_clusters, 2.0))
    cluster = rng.choice(n_clusters, size=n, p=weights)
    spread = rng.uniform(0.25, 0.6, size=n_clusters).astype(np.float32)
    x = centers[cluster] + rng.normal(0, 1, size=(n, d)).astype(np.float32) * spread[
        cluster, None
    ]
    return x, cluster.astype(np.int32)


def _zipf_codes(
    rng: np.random.Generator, n: int, card: int, corr: np.ndarray, corr_strength: float
) -> np.ndarray:
    """Zipf-distributed codes, partially correlated with cluster id."""
    ranks = np.arange(1, card + 1, dtype=np.float64)
    p = (1.0 / ranks**1.1)
    p /= p.sum()
    base = rng.choice(card, size=n, p=p)
    from_cluster = corr % card
    take = rng.random(n) < corr_strength
    return np.where(take, from_cluster, base).astype(np.int32)


def make_dataset(name: str, scale: str = "reduced", seed: int = 0) -> VectorDataset:
    paper_n, d, kinds = DATASETS[name]
    n = paper_n if scale == "full" else (_REDUCED_N[name] if scale == "reduced" else int(scale))
    rng = np.random.default_rng(seed + hash(name) % 2**16)
    n_clusters = 64
    x, cluster = _mixture_vectors(rng, n, d, n_clusters)

    if name == "arxiv":
        # mixed metadata: category labels (Zipf, 40 codes), sub-topic (25),
        # license (5); numeric: year-like + citation-count-like.
        cat = np.stack(
            [
                _zipf_codes(rng, n, 40, cluster, 0.5),
                _zipf_codes(rng, n, 25, cluster, 0.3),
                _zipf_codes(rng, n, 5, cluster, 0.0),
            ],
            axis=1,
        )
        year = 1995 + (cluster % 8) * 3 + rng.normal(8, 6, n)
        cites = rng.lognormal(2.0, 1.5, n)
        num = np.stack([year, cites], axis=1).astype(np.float32)
    elif name == "wolt":
        # range-only workload on real-valued attrs: price-like lognormal,
        # delivery-time-like gamma; one incidental categorical kept for
        # completeness (not used by the range workload).
        cat = _zipf_codes(rng, n, 30, cluster, 0.4)[:, None]
        price = rng.lognormal(2.5, 0.7, n) + (cluster % 4) * 3.0
        minutes = rng.gamma(6.0, 5.0, n)
        rating = np.clip(rng.normal(8.2, 1.1, n), 1, 10)
        num = np.stack([price, minutes, rating], axis=1).astype(np.float32)
    else:  # glove200 / sift: synthetic numeric attributes (paper §4.1)
        cat = _zipf_codes(rng, n, 20, cluster, 0.3)[:, None]
        u = rng.normal(0, 1, n) + (cluster % 8) * 0.7
        v = rng.lognormal(1.0, 1.0, n)
        num = np.stack([u, v], axis=1).astype(np.float32)

    return VectorDataset(name=name, vectors=x, cat=cat, num=num, filter_kinds=kinds)
