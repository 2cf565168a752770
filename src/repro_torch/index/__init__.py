from .acorn import AcornIndex
from .flat import FlatIndex, chunked_masked_topk, l2_topk
from .ivf import IVFIndex
from .kmeans import kmeans
from .pq import IVFPQIndex
from .registry import (
    DEFAULT_BACKENDS,
    BackendSet,
    KnobTier,
    LiveIndex,
    SearchBackend,
    backend_names,
    make_backend,
    register_backend,
    unregister_backend,
)

__all__ = ["FlatIndex", "IVFIndex", "AcornIndex", "IVFPQIndex", "kmeans", "l2_topk",
           "chunked_masked_topk", "BackendSet", "KnobTier", "LiveIndex", "SearchBackend",
           "DEFAULT_BACKENDS", "backend_names", "make_backend", "register_backend",
           "unregister_backend"]
