"""llama3.2-3b [dense] — 28L, d3072, 24H GQA kv=8, ff 8192, vocab 128256.
Small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=500_000.0,
    tie_embeddings=True,
)
