"""Serving step builders: the counterparts of the reference's
``repro.train.steps.make_prefill_step`` / ``make_decode_step``.

PyTorch runs eagerly, so a step is the plain function the reference
would hand to ``jax.jit``.  Sharded execution (``mesh``) belongs to the
distributed layer, which the port does not have yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M

Params = dict


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the port has no distributed layer yet: "
                                  "pass mesh=None")


def make_prefill_step(cfg, mesh=None, *, max_seq: int | None = None,
                      plan=None):
    """Prefill step builder.  ``plan`` threads a (bucketed) prefill
    BlockPlan through the model's MLP dispatch; ``max_seq`` right-pads the
    returned caches for in-place decode appends.  The step takes an
    optional ``last_pos`` so bucket-padded prompts read their logits at
    the true last token."""
    _no_mesh(mesh)

    @torch.no_grad()
    def step_fn(params: Params, batch: dict, last_pos=None):
        return M.prefill(cfg, params, batch, max_seq=max_seq, plan=plan,
                         last_pos=last_pos)

    return step_fn


def make_decode_step(cfg, mesh=None, *, plan=None):
    """One token against a full cache.  ``pos`` may be a scalar or a
    per-row ``(B,)`` vector; ``plan`` threads the m=1 decode BlockPlan
    through the model's MLP dispatch.  The cache is updated in place."""
    _no_mesh(mesh)

    @torch.no_grad()
    def step_fn(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor):
        return M.decode_step(cfg, params, token, cache, pos, plan=plan)

    return step_fn
