"""llama-3.2-vision-90b [vlm] — 100L, d8192, 64H GQA kv=8, ff 28672,
vocab 128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a STUB per the task spec: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, n_image_tokens, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1600,
)
