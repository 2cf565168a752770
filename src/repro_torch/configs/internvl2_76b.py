"""internvl2-76b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    frontend="vision",
    frontend_len=256,   # precomputed patch embeddings per image (stub)
)
