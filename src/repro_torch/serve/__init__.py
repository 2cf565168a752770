from .engine import Request, ServeEngine
from .retrieval import RetrievalAugmentedServer

__all__ = ["ServeEngine", "Request", "RetrievalAugmentedServer"]
