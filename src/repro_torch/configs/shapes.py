"""Assigned input-shape cells (the 4 shapes each architecture runs): the
port's copy of ``repro.configs.shapes``.

``kind`` selects which step the dry-run traces
(``repro_torch.launch.dryrun``):
  * train   -> train_step  (fwd+bwd+optimizer update)
  * prefill -> serve prefill (forward, returns logits + KV cache)
  * decode  -> serve decode (one token against a seq_len-sized KV cache)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str             # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]
