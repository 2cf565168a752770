from .ops import decode_attention, fused_masked_topk, masked_l2_topk
from .ref import decode_attention_ref, masked_l2_topk_ref

__all__ = ["masked_l2_topk", "fused_masked_topk", "masked_l2_topk_ref",
           "decode_attention", "decode_attention_ref"]
