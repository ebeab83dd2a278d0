"""whisper-base [audio] — 6L enc + 6L dec, d512, 8H MHA, ff 2048,
vocab 51865; encoder-decoder with conv frontend STUB: ``input_specs()``
provides precomputed frame embeddings (batch, 1500, d_model).
[arXiv:2212.04356; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    mlp_act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,
)
