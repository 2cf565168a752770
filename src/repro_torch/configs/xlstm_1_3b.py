"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (recurrent, O(1) decode state).
[arXiv:2405.04517; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                # xLSTM blocks carry their own up/down projections
    vocab_size=50_304,
    head_dim=512,
    slstm_every=8,         # every 8th block is sLSTM (7:1 mLSTM:sLSTM)
    subquadratic=True,
)
