"""qwen2-moe-a2.7b [moe] — 24L, d2048, 16H MHA kv=16, per-expert ff 1408,
vocab 151936; 60 routed experts top-4 + 4 shared (shared hidden 5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Note E=60 does not divide the 16-way model axis: the FTL sharding
constraint family selects per-expert TP (d_ff sharding) instead of EP for
this arch (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    head_dim=128,
    mlp_act="silu",
    mlp_gated=True,
    qkv_bias=True,
    n_experts=60,
    n_experts_per_token=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
)
