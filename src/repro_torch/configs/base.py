"""Model/config schema for the architecture zoo.

One frozen dataclass describes every assigned architecture (dense GQA,
MoE, xLSTM, RG-LRU hybrid, encoder-decoder audio, cross-attn VLM).  Each
``src/repro/configs/<arch>.py`` exports ``CONFIG``; ``shapes.py`` defines
the four assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None          # default d_model // n_heads
    mlp_act: str = "silu"
    mlp_gated: bool = True
    mlp_bias: bool = False
    qkv_bias: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # per-expert hidden
    shared_d_ff: int = 0                 # shared-expert hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- xLSTM (ssm) ---------------------------------------------------------
    slstm_every: int = 0                 # every Nth block is sLSTM (0 = none)
    xlstm_expand: int = 2                # mLSTM up-projection factor

    # --- hybrid (recurrentgemma) --------------------------------------------
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over layers
    local_window: int | None = None      # local-attention window
    lru_width: int | None = None         # RG-LRU state width
    conv_width: int = 4                  # temporal conv in recurrent block

    # --- vlm ------------------------------------------------------------------
    cross_attn_every: int = 0            # every Nth layer is x-attn (0 = none)
    n_image_tokens: int = 0              # stub frontend: precomputed embeddings

    # --- encoder-decoder (audio) -----------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0                 # stub frontend frames

    # --- execution -----------------------------------------------------------
    dtype: str = "bfloat16"              # activation/param compute dtype
    ftl_mode: Literal["off", "fused", "scan", "auto"] = "off"
    remat: bool = True
    # MoE dispatch: 'scatter' (global rank scatter — baseline) or
    # 'grouped' (GShard-style per-group dispatch; ranks never cross data
    # shards, resharding lowers to all-to-all) — §Perf lever.
    moe_dispatch: Literal["scatter", "grouped"] = "scatter"
    moe_groups: int = 0                  # 0 = one group per data shard (16)
    # mLSTM time-chunked remat: 0 = plain scan (saves per-step state for
    # bwd), N = chunk size (saves only chunk boundaries) — §Perf lever.
    mlstm_chunk: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def block_kind(self, layer: int) -> str:
        """Temporal-mixing kind of layer ``layer``: attn | cross | mlstm |
        slstm | rec | local."""
        if self.family == "ssm":
            if self.slstm_every and (layer + 1) % self.slstm_every == 0:
                return "slstm"
            return "mlstm"
        if self.family == "hybrid":
            return self.block_pattern[layer % len(self.block_pattern)]
        if self.family == "vlm" and self.cross_attn_every and (
            (layer + 1) % self.cross_attn_every == 0
        ):
            return "cross"
        return "attn"

    def attention_free(self) -> bool:
        """True if no layer does full quadratic attention (long_500k rule)."""
        kinds = {self.block_kind(i) for i in range(self.n_layers)}
        return "attn" not in kinds and "cross" not in kinds

    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell: recurrent and/or local-attn only."""
        kinds = {self.block_kind(i) for i in range(self.n_layers)}
        quad = {"attn", "cross"} & kinds
        if not quad:
            return True
        # local attention counts as sub-quadratic
        return kinds <= {"rec", "local", "mlstm", "slstm"}

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid"
                         else max(3, len(self.block_pattern))),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            dtype="float32",
            remat=False,
        )
        if self.is_moe:
            scale.update(n_experts=8, n_experts_per_token=2, moe_d_ff=64,
                         shared_d_ff=64 if self.shared_d_ff else 0)
        if self.family == "ssm":
            scale.update(n_heads=2, head_dim=None)
        if self.family == "hybrid":
            scale.update(local_window=32, lru_width=128)
        if self.family == "vlm":
            scale.update(n_image_tokens=16, cross_attn_every=2)
        if self.is_encoder_decoder:
            scale.update(n_encoder_layers=2, encoder_seq=64)
        return dataclasses.replace(self, **scale)
