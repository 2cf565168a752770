"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer; sliding
window attention except 3 global layers; SSM state 16.
[arXiv:2411.13676; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    ssm_state=16,
    sliding_window=1024,
    layer_pattern="hymba",
    global_layers=(0, 15, 31),   # full-attention layers; rest sliding-window
    subquadratic=True,
)
