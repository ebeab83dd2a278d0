"""PyTorch/CUDA port of the Fused-Tiled Layers system.

Same module layout and public names as the JAX package ``repro``, which
stays the reference: ``configs``, ``core.hw`` and the ``core.ftl``
planner, ``kernels`` (hand-written CUDA kernels for Hopper beside their
plain PyTorch versions), ``models``, ``train.steps`` and ``launch``
(paged-KV continuous-batching serving).  Nothing here imports jax or
``repro``.
"""
