"""olmoe-1b-7b [moe] — 64 experts, top-8 routing. [arXiv:2409.02060; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,             # per-expert FFN width
    vocab_size=50_304,
    head_dim=128,
    n_experts=64,
    top_k_experts=8,
    qk_norm=True,
)
