"""recurrentgemma-9b [hybrid] — 38L, d4096, 16H MQA kv=1, ff 12288,
vocab 256000; RG-LRU recurrent blocks + local attention at 2:1
(pattern rec, rec, local; window 2048).  [arXiv:2402.19427; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp_act="gelu",
    mlp_gated=True,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
)
