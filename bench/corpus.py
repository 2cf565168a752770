"""The configuration's corpus, drawn on the device from the run's seed.

A frozen rewrite, in torch, of the synthetic stand-ins for the paper's
Table 1 datasets: a Gaussian mixture of ``clusters`` centres N(0, 1) with
Dirichlet weights and per-cluster spreads drawn uniformly from ``spread``;
categorical codes drawn by Zipf rank and, for a share of the rows, taken
from the row's cluster (filters correlate with geometry); numeric columns
drawn from the distributions the configuration names, shifted by the
cluster where it says so.

Everything is drawn by one ``torch.Generator`` on the device, in a fixed
order and in a few large calls, seeded from ``--seed`` and the
configuration's own ``seed_offset``, so one seed gives the same arrays in
every process on one kind of device.  The mixture's weights and spreads
are the exception: they are the configuration's, drawn from its
``seed_offset`` alone, so every seed has the same set of cluster sizes
(and so of IVF list sizes) and differs in the centres, the rows and their
metadata.  Gamma draws take whole shapes only (a sum of exponentials),
which is all the configurations use.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["Corpus", "derive_seed", "generate", "query_vectors", "STREAMS"]

# the independent random streams of one run, each seeded from (seed, offset, stream)
STREAMS = {"corpus": 1, "train": 2, "traffic": 3, "vectors": 4, "sample": 5, "engine": 6}
CHUNK = 1 << 18      # rows handled at once where a temporary would be (rows, d)


def derive_seed(seed: int, offset: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run; any whole ``seed`` works."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(offset), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


@dataclasses.dataclass
class Corpus:
    vectors: torch.Tensor   # (N, d) float32
    cat: torch.Tensor       # (N, A_cat) int32
    num: torch.Tensor       # (N, A_num) float32
    std: float              # standard deviation of every vector element

    @property
    def n(self) -> int:
        return self.vectors.shape[0]


def _gamma(g, shape: float, scale: float, size, device) -> torch.Tensor:
    """Gamma(shape, scale) for a whole ``shape``: a sum of exponentials."""
    a = int(shape)
    if a != shape or a < 1:
        raise ValueError(f"gamma shape {shape} is not a whole number >= 1")
    u = torch.rand((a, *size), generator=g, device=device)
    return -torch.log1p(-u).sum(0) * scale


def _numeric(g, spec: dict, cluster: torch.Tensor, device) -> torch.Tensor:
    n = cluster.shape[0]
    dist = spec["dist"]
    if dist == "normal":
        x = spec["loc"] + spec["scale"] * torch.randn(n, generator=g, device=device)
    elif dist == "lognormal":
        x = torch.exp(spec["mean"] + spec["sigma"] * torch.randn(n, generator=g, device=device))
    elif dist == "gamma":
        x = _gamma(g, spec["shape"], spec["scale"], (n,), device)
    else:
        raise ValueError(f"unknown numeric distribution {dist!r}")
    x = x + spec.get("offset", 0.0)
    if spec.get("cluster_mod"):
        x = x + (cluster % spec["cluster_mod"]).float() * spec["cluster_step"]
    if "clip" in spec:
        x = x.clamp(*spec["clip"])
    return x.float()


def generate(cfg: dict, seed: int, device) -> Corpus:
    """The corpus of configuration ``cfg`` for ``seed`` on ``device``."""
    device = torch.device(device)
    n, d, c = cfg["rows"], cfg["dim"], cfg["clusters"]
    g = torch.Generator(device="cpu").manual_seed(int(cfg["seed_offset"]))
    weights = _gamma(g, cfg["dirichlet"], 1.0, (c,), "cpu")
    weights = (weights / weights.sum()).to(device)
    lo, hi = cfg["spread"]
    spread = (lo + (hi - lo) * torch.rand(c, generator=g)).to(device)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, cfg["seed_offset"], "corpus"))
    centers = torch.randn((c, d), generator=g, device=device)
    cluster = torch.multinomial(weights, n, replacement=True, generator=g)
    x = torch.randn((n, d), generator=g, device=device)
    for s in range(0, n, CHUNK):
        cl = cluster[s:s + CHUNK]
        x[s:s + CHUNK].mul_(spread[cl].unsqueeze(1)).add_(centers[cl])
    cats: List[torch.Tensor] = []
    for spec in cfg["categorical"]:
        card = spec["codes"]
        p = 1.0 / torch.arange(1, card + 1, device=device, dtype=torch.float64) ** spec["zipf"]
        base = torch.multinomial((p / p.sum()).float(), n, replacement=True, generator=g)
        take = torch.rand(n, generator=g, device=device) < spec["cluster_share"]
        cats.append(torch.where(take, cluster % card, base).to(torch.int32))
    nums = [_numeric(g, spec, cluster, device) for spec in cfg["numeric"]]
    # the element std in float64, a chunk at a time (the query noise scale)
    s1 = s2 = 0.0
    for s in range(0, n, CHUNK):
        blk = x[s:s + CHUNK].double()
        s1 += float(blk.sum())
        s2 += float((blk * blk).sum())
    m = s1 / (n * d)
    std = float(np.sqrt(max(s2 / (n * d) - m * m, 0.0)))
    cat = torch.stack(cats, 1) if cats else torch.zeros((n, 0), dtype=torch.int32, device=device)
    num = torch.stack(nums, 1) if nums else torch.zeros((n, 0), device=device)
    return Corpus(x, cat, num, std)


def query_vectors(corpus: Corpus, n_queries: int, noise: float, seed: int) -> np.ndarray:
    """(n_queries, d) host float32: corpus rows drawn uniformly, plus
    N(0, (noise * std)^2) per element, drawn on the corpus's device."""
    dev = corpus.vectors.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, corpus.n, (n_queries,), generator=g, device=dev)
    out = np.empty((n_queries, corpus.vectors.shape[1]), np.float32)
    for s in range(0, n_queries, CHUNK):
        r = rows[s:s + CHUNK]
        q = corpus.vectors[r] + torch.randn((r.shape[0], corpus.vectors.shape[1]), generator=g,
                                            device=dev) * (noise * corpus.std)
        out[s:s + r.shape[0]] = q.cpu().numpy()
    return out
