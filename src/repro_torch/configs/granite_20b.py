"""granite-20b [dense] — 52L, d6144, 48H MQA kv=1, ff 24576, vocab 49152.
Code model, GPT-BigCode-style: un-gated GeLU MLP with biases — this is the
paper's GEMM+GeLU benchmark at production scale (DESIGN.md §7).
[arXiv:2405.04324; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp_act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
)
