from .flat import FlatIndex, chunked_masked_topk, l2_topk
from .ivf import IVFIndex
from .kmeans import kmeans

__all__ = ["FlatIndex", "IVFIndex", "kmeans", "l2_topk", "chunked_masked_topk"]
