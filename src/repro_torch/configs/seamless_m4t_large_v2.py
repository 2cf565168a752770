"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone; the speech
frontend is a stub supplying precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    n_enc_layers=24,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    frontend="audio",
    frontend_len=1024,      # precomputed speech frames per example (stub)
)
