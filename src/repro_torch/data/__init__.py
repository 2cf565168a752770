from .pipeline import TokenPipeline
from .vectors import make_dataset, DATASETS, VectorDataset

__all__ = ["make_dataset", "DATASETS", "VectorDataset", "TokenPipeline"]
