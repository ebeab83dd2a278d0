"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
wrappers (:mod:`.gemm`, :mod:`.flash_attention`, :mod:`.fused_mlp`), the
plain PyTorch versions (:mod:`.ref`) and the planned dispatch
(:mod:`.ops`).  Importing builds nothing: the CUDA library is compiled at
the first launch."""
from . import ops, ref  # noqa: F401
