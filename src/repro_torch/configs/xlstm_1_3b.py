"""xlstm-1.3b [ssm] — 48L, d2048, 4 mLSTM heads, vocab 50304; sLSTM +
mLSTM blocks at the paper's 7:1 ratio (every 8th block is sLSTM).
No separate FFN (d_ff=0): the up/down projections live inside the block.
[arXiv:2405.04517; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    slstm_every=8,
    xlstm_expand=2,
)
