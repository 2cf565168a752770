"""Cross-shard merges (``collectives``); port of ``repro/dist``, cut to the
two top-k merges the DNF plans use."""
from .collectives import merge_topk, merge_topk_unique

__all__ = ["merge_topk", "merge_topk_unique"]
