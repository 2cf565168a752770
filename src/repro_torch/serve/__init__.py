from .engine import Request, ServeEngine, ShardedANNEngine
from .retrieval import RetrievalAugmentedServer

__all__ = ["ServeEngine", "Request", "RetrievalAugmentedServer", "ShardedANNEngine"]
