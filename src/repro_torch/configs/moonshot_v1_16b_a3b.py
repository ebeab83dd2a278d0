"""moonshot-v1-16b-a3b [moe] — 48L, d2048, 16H MHA kv=16, per-expert ff 1408,
vocab 163840; MoE 64 routed experts top-6 (+2 shared, Moonlight-style).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=163840,
    head_dim=128,
    mlp_act="silu",
    mlp_gated=True,
    n_experts=64,
    n_experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    shared_d_ff=2816,
    rope_theta=50_000.0,
)
