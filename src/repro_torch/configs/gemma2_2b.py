"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern="local_global",
    embed_scale=True,
    post_norms=True,
    tie_embeddings=True,
    # alternating local layers bound the KV working set; global layers are
    # O(L) per decoded token -> long_500k decode is runnable (DESIGN.md §4)
    subquadratic=True,
)
