from .ops import fused_masked_topk, masked_l2_topk
from .ref import masked_l2_topk_ref

__all__ = ["masked_l2_topk", "fused_masked_topk", "masked_l2_topk_ref"]
