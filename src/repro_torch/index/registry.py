"""Pluggable ANN-backend registry — the engine's (plan, backend, knob) space.

Port of ``repro/index/registry.py``.  Every backend exposes one surface:

* ``build(corpus)`` — construct from an (N, d) float32 corpus (numpy, or a
  tensor that is shared when it already lies on the backend's device);
* ``search_masked(queries, mask, k, knobs)`` — host (dists (B, k), ids
  (B, k)), the host (N,) bool mask applied during the search (no
  filtered-out id may surface);
* ``memory_bytes()`` — scan-resident footprint;
* ``knob_grid()`` — declared :class:`KnobTier` list; each tier names a knob
  setting and the recall@10 floor it promises.

Registered by default, with the reference's knob grids and floors:
``flat`` (the exact masked scan: ``kernels.ops.fused_masked_topk``, the
CUDA ``masked_l2_topk`` kernel on the card), ``ivf`` (IVF-Flat probe scan),
``ivfpq`` (:class:`~repro_torch.index.pq.IVFPQIndex`, uint8 ADC + exact
re-rank) and ``acorn`` (predicate-aware graph traversal, the host search).
A factory is called as ``factory(seed=..., device=...)``.

Corpora below ``TINY_N`` rows make every backend the exact masked scan:
the reference's numpy scan (:func:`_exact_masked`) on the CPU, the kernel
on the card.  :class:`BackendSet` is what the engine holds:
one built instance per backend and the flattened ``classes()`` enumeration
``[(backend, tier), ...]`` the planner's routing head indexes into.
:class:`LiveIndex` serves any built backend over a mutated corpus.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.ops import fused_masked_topk, record_dispatch
from .acorn import AcornIndex, _host
from .ivf import IVFIndex
from .pq import IVFPQIndex

__all__ = [
    "KnobTier",
    "SearchBackend",
    "BackendSet",
    "LiveIndex",
    "register_backend",
    "unregister_backend",
    "backend_names",
    "make_backend",
    "DEFAULT_BACKENDS",
    "TINY_N",
]

# below this corpus size every backend falls back to the exact masked scan
TINY_N = 64


@dataclass(frozen=True)
class KnobTier:
    """One named knob setting with the recall@10 floor it declares; the
    engine's routing classes are (backend, tier) pairs."""
    name: str
    knobs: Mapping[str, int] = field(default_factory=dict)
    recall_floor: float = 0.5


class SearchBackend(Protocol):
    """Uniform backend surface; see the module docstring."""

    name: str

    def build(self, corpus) -> "SearchBackend": ...

    def search_masked(
        self,
        queries: np.ndarray,
        mask: Optional[np.ndarray],
        k: int,
        knobs: Optional[Mapping[str, int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]: ...

    def memory_bytes(self) -> int: ...

    def knob_grid(self) -> Tuple[KnobTier, ...]: ...


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------
def _empty_result(b: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.full((b, k), np.inf, np.float32), np.full((b, k), -1, np.int32)


def _exact_masked(
    vectors: np.ndarray, queries: np.ndarray, mask: Optional[np.ndarray], k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact masked top-k in numpy with composite (distance bits, id) keys;
    every row is its own broadcast/reduce, so results do not depend on the
    batch.  The tiny-corpus fallback of every backend."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    b = q.shape[0]
    out_d, out_i = _empty_result(b, k)
    n = vectors.shape[0]
    if n == 0:
        return out_d, out_i
    d2 = ((q[:, None, :] - vectors[None]) ** 2).sum(-1).astype(np.float32)
    d2 = np.maximum(d2, 0.0)
    if mask is not None:
        d2 = np.where(np.asarray(mask, bool)[None, :], d2, np.inf)
    key = (d2.view(np.int32).astype(np.int64) << 32) | np.arange(n, dtype=np.int64)[None]
    kk = min(k, n)
    sel = np.argsort(key, axis=1, kind="stable")[:, :kk]
    sd = np.take_along_axis(d2, sel, axis=1)
    fin = np.isfinite(sd)
    out_d[:, :kk] = np.where(fin, sd, np.inf)
    out_i[:, :kk] = np.where(fin, sel.astype(np.int32), -1)
    return out_d, out_i


class _Backend:
    """Shared construction: the corpus on the device (and, on the CPU, a
    host copy for the tiny-corpus scan), and the exact masked scan."""

    name = ""

    def __init__(self, seed: int = 0, device=DEFAULT_DEVICE):
        self.seed = seed
        self.device = device

    def _take(self, corpus) -> bool:
        """Keep ``corpus``; True when it is large enough to index."""
        self.device = resolve_device(self.device)
        self.vectors = torch.as_tensor(corpus, dtype=torch.float32, device=self.device)
        self.n, self.dim = self.vectors.shape
        cpu_tiny = self.n < TINY_N and self.device.type == "cpu"
        self._tiny = _host(corpus) if cpu_tiny else None
        return self.n >= TINY_N

    def _exact(self, q: np.ndarray, mask, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact masked top-k over the whole corpus, ties to the lowest id:
        ``fused_masked_topk`` (the CUDA kernel on the card), or below
        ``TINY_N`` rows on the CPU the reference's numpy scan."""
        if self._tiny is not None:
            return _exact_masked(self._tiny, q, mask, k)
        out_d, out_i = _empty_result(q.shape[0], k)
        if self.n == 0:
            return out_d, out_i
        kk = min(k, self.n)
        m = (torch.ones(self.n, dtype=torch.bool, device=self.device) if mask is None
             else torch.as_tensor(np.asarray(mask, bool), device=self.device))
        d, i = fused_masked_topk(torch.as_tensor(q, device=self.device), self.vectors, m, kk)
        out_d[:, :kk] = d.cpu().numpy()
        out_i[:, :kk] = i.cpu().numpy()
        return out_d, out_i

    def _vector_bytes(self) -> int:
        return int(self.vectors.numel() * self.vectors.element_size())


# ----------------------------------------------------------------------
# backend adapters
# ----------------------------------------------------------------------
class FlatBackend(_Backend):
    """Exact masked scan — the recall ceiling and memory baseline.  Runs
    ``fused_masked_topk`` (the kernel's lowest-id tie rule is what makes an
    exact per-clause union equal the whole-predicate scan) over the corpus
    it was built on, which it shares with the caller."""

    name = "flat"

    def build(self, corpus) -> "FlatBackend":
        self._take(corpus)
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        return self._exact(np.atleast_2d(np.asarray(queries, np.float32)), mask, k)

    def memory_bytes(self) -> int:
        return self._vector_bytes()

    def knob_grid(self) -> Tuple[KnobTier, ...]:
        return (KnobTier("exact", {}, recall_floor=0.99),)


class IVFBackend(_Backend):
    """IVF-Flat probe-list scan (wraps :class:`IVFIndex`)."""

    name = "ivf"

    def __init__(self, n_lists: Optional[int] = None, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__(seed, device)
        self.n_lists = n_lists

    def build(self, corpus, index: Optional[IVFIndex] = None) -> "IVFBackend":
        """``index``: an IVF index the caller built over this same corpus
        tensor (the engine's); it is taken instead of a second k-means when
        its list count and seed are this backend's own."""
        self.index = None
        if self._take(corpus):
            own = IVFIndex(self.vectors, n_lists=self.n_lists, seed=self.seed,
                           device=self.device)
            same = (index is not None and index.built
                    and index.vectors.data_ptr() == self.vectors.data_ptr()
                    and index.n == self.n
                    and (index.n_lists, index.seed) == (own.n_lists, own.seed))
            self.index = index if same else own.build()
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.index is None:
            return self._exact(q, mask, k)
        nprobe = int((knobs or {}).get("nprobe", 8))
        return self.index.search(q, k, nprobe=nprobe,
                                 mask=None if mask is None else np.asarray(mask, bool))

    def memory_bytes(self) -> int:
        """The index's lists, centroids and layout; the reference also
        counts its jit path's padded id table, which the port has not."""
        if self.index is None:
            return self._vector_bytes()
        ix = self.index
        dev = sum(t.numel() * t.element_size()
                  for t in (ix.sorted_vecs, ix.centroids, ix.sorted_ids, ix.sorted_sq))
        return int(dev + ix.offsets.nbytes)

    def knob_grid(self) -> Tuple[KnobTier, ...]:
        return (
            KnobTier("fast", {"nprobe": 8}, recall_floor=0.50),
            KnobTier("balanced", {"nprobe": 16}, recall_floor=0.70),
            KnobTier("precise", {"nprobe": 64}, recall_floor=0.90),
        )


class IVFPQBackend(_Backend):
    """IVF-PQ uint8 ADC scan with exact re-rank (wraps :class:`IVFPQIndex`)."""

    name = "ivfpq"

    def __init__(self, n_lists: Optional[int] = None, m: Optional[int] = None,
                 seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__(seed, device)
        self.n_lists = n_lists
        self.m = m

    def build(self, corpus) -> "IVFPQBackend":
        self.index = None
        if self._take(corpus):
            self.index = IVFPQIndex(self.vectors, n_lists=self.n_lists, m=self.m,
                                    seed=self.seed, device=self.device).build()
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.index is None:
            return self._exact(q, mask, k)
        kn = knobs or {}
        return self.index.search(
            q, k,
            nprobe=int(kn.get("nprobe", 8)),
            rerank=int(kn.get("rerank", 64)),
            mask=None if mask is None else np.asarray(mask, bool),
        )

    def memory_bytes(self) -> int:
        if self.index is None:
            return self._vector_bytes()
        return self.index.memory_bytes()

    @property
    def rerank_bytes(self) -> int:
        return 0 if self.index is None else self.index.rerank_bytes

    def knob_grid(self) -> Tuple[KnobTier, ...]:
        return (
            KnobTier("fast", {"nprobe": 8, "rerank": 32}, recall_floor=0.45),
            KnobTier("precise", {"nprobe": 64, "rerank": 256}, recall_floor=0.80),
        )


class AcornBackend(_Backend):
    """ACORN-1 predicate-aware graph traversal (wraps :class:`AcornIndex`;
    serves with its host ``search``)."""

    name = "acorn"

    def __init__(self, m: int = 24, seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__(seed, device)
        self.m = m

    def build(self, corpus) -> "AcornBackend":
        self.index = None
        if self._take(corpus):
            self.index = AcornIndex(self.vectors, m=self.m, seed=self.seed,
                                    device=self.device).build()
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.index is None:
            return self._exact(q, mask, k)
        ef = int((knobs or {}).get("ef", 64))
        return self.index.search(q, k, ef=ef,
                                 mask=None if mask is None else np.asarray(mask, bool))

    def memory_bytes(self) -> int:
        if self.index is None:
            return self._vector_bytes()
        ix = self.index
        return int(self._vector_bytes() + ix.neighbors.nbytes + ix.seeds.nbytes)

    def knob_grid(self) -> Tuple[KnobTier, ...]:
        return (
            KnobTier("fast", {"ef": 64}, recall_floor=0.45),
            KnobTier("precise", {"ef": 160}, recall_floor=0.70),
        )


class LiveIndex:
    """Mutation-aware view over one BUILT backend: composes a
    :class:`~repro_torch.core.corpus.LiveCorpus`'s tombstones into every
    mask and merges an exact scan of the append segment into the backend's
    base results, so any registered backend serves a mutated corpus without
    a rebuild (a tombstoned id never surfaces; the floors hold over the live
    rows).

    The segment scan is ``fused_masked_topk`` over the segment's device rows
    (the kernel on the card), whose (query, row) distance and lowest-id tie
    rule are the exact backends' own: exact tiers stay bit-identical to a
    fresh build over the compacted corpus.  ``l2_topk`` (``torch.topk``)
    promises no tie order, so it is not used here."""

    def __init__(self, base: SearchBackend, live):
        self.base = base
        self.live = live
        self.name = base.name

    def build(self, corpus) -> "LiveIndex":
        self.base.build(corpus)
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        live = self.live
        base_n = live.base_n
        alive = live.alive_mask()
        if mask is None:
            bmask, smask = alive[:base_n], alive[base_n:]
        else:
            m = np.asarray(mask, bool)
            if m.size == live.n_total:
                bmask, smask = m[:base_n] & alive[:base_n], m[base_n:] & alive[base_n:]
            else:
                # a base-length mask predates the segment: segment rows are
                # filtered by liveness alone
                bmask, smask = m & alive[:base_n], alive[base_n:]
        bd, bi = self.base.search_masked(q, bmask, k, knobs=knobs)
        if live.seg_n and smask.any():
            from ..dist.collectives import merge_topk

            seg = live.seg_vectors_dev()
            out_d, out_i = _empty_result(q.shape[0], k)
            kk = min(k, live.seg_n)
            sd, si = fused_masked_topk(torch.as_tensor(q, device=seg.device), seg,
                                       torch.as_tensor(smask, device=seg.device), kk)
            si = si.cpu().numpy()
            out_d[:, :kk] = sd.cpu().numpy()
            out_i[:, :kk] = np.where(si >= 0, si + base_n, -1)
            # base part first: equal distances keep handle order
            bd, bi = merge_topk(np.stack([bd, out_d]), np.stack([bi, out_i]), k)
        return bd, bi

    def memory_bytes(self) -> int:
        seg = self.live.seg_n * self.live.dim * 4
        return int(self.base.memory_bytes() + seg + self.live.tomb.nbytes)

    def knob_grid(self) -> Tuple[KnobTier, ...]:
        return self.base.knob_grid()


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
_REGISTRY: "OrderedDict[str, Callable[..., SearchBackend]]" = OrderedDict()


def register_backend(name: str, factory: Callable[..., SearchBackend],
                     overwrite: bool = False) -> None:
    """Register ``factory(seed=..., device=...) -> SearchBackend`` under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = factory


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def backend_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def make_backend(name: str, corpus, seed: int = 0,
                 device=DEFAULT_DEVICE) -> SearchBackend:
    """Construct and build a registered backend over ``corpus`` on ``device``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: {backend_names()}")
    if not isinstance(corpus, torch.Tensor):
        corpus = np.asarray(corpus, np.float32)
    return _REGISTRY[name](seed=seed, device=device).build(corpus)


register_backend("flat", FlatBackend)
register_backend("ivf", IVFBackend)
register_backend("ivfpq", IVFPQBackend)
register_backend("acorn", AcornBackend)

DEFAULT_BACKENDS: Tuple[str, ...] = ("flat", "ivf", "ivfpq", "acorn")


# ----------------------------------------------------------------------
# BackendSet — what the engine holds
# ----------------------------------------------------------------------
class BackendSet:
    """Built backend instances plus the flattened (backend, tier) routing
    classes the planner's routing head indexes into: backends in the given
    order crossed with each one's declared tiers, so a routing label is
    stable across runs."""

    def __init__(self, backends: "OrderedDict[str, SearchBackend]"):
        self.backends = backends
        tiers = [(bname, tier) for bname, b in backends.items() for tier in b.knob_grid()]
        self._classes: Tuple[Tuple[str, str], ...] = tuple((bn, t.name) for bn, t in tiers)
        self._knobs: Tuple[Mapping[str, int], ...] = tuple(t.knobs for _, t in tiers)
        self._floors: Tuple[float, ...] = tuple(t.recall_floor for _, t in tiers)

    @classmethod
    def build(cls, corpus, names: Optional[Sequence[str]] = None,
              seed: int = 0, device=DEFAULT_DEVICE,
              ivf: Optional[IVFIndex] = None) -> "BackendSet":
        """Build ``names`` (default ``DEFAULT_BACKENDS``) over ``corpus``.
        ``ivf``: an IVF index already built over ``corpus`` (the engine's),
        which the registered ``ivf`` backend shares when its layout would be
        the same (:meth:`IVFBackend.build`)."""
        names = tuple(names) if names else DEFAULT_BACKENDS
        built: "OrderedDict[str, SearchBackend]" = OrderedDict()
        for nm in names:
            if nm == "ivf" and ivf is not None and _REGISTRY.get(nm) is IVFBackend:
                built[nm] = IVFBackend(seed=seed, device=device).build(corpus, index=ivf)
            else:
                built[nm] = make_backend(nm, corpus, seed=seed, device=device)
        return cls(built)

    def classes(self) -> Tuple[Tuple[str, str], ...]:
        return self._classes

    def class_names(self) -> Tuple[str, ...]:
        return tuple(f"{b}:{t}" for b, t in self._classes)

    def recall_floor(self, ci: int) -> float:
        return self._floors[ci]

    def search_class(self, ci: int, queries: np.ndarray,
                     mask: Optional[np.ndarray], k: int):
        bname, _ = self._classes[ci]
        t0 = time.perf_counter()
        out = self.backends[bname].search_masked(queries, mask, k,
                                                 knobs=self._knobs[ci])
        record_dispatch(f"backend_{bname}", time.perf_counter() - t0)
        return out

    def memory_bytes(self) -> Dict[str, int]:
        return {nm: b.memory_bytes() for nm, b in self.backends.items()}
