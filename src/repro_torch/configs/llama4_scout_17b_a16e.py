"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,             # per-expert FFN width
    vocab_size=202_048,
    head_dim=128,
    n_experts=16,
    top_k_experts=1,
    moe_shared_expert=True,
)
