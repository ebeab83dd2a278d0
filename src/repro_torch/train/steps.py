"""Step builders of the port: the counterparts of the reference's
``repro.train.steps``, the train step with gradient accumulation and the
two serving steps.

PyTorch runs eagerly, so a step is the plain function the reference
would hand to ``jax.jit``.  Sharded execution (``mesh``) and gradient
compression (``compress``) belong to the distributed layer, which the
port does not have yet: both are refused.

The train step takes gradients with ``torch.autograd.grad`` over the
parameter leaves and casts them to fp32; a leaf that no gradient reaches
(the empty ``(0, ...)`` stacks of a config with no whole period) counts
as zeros.  The AdamW update then runs in place
(:func:`repro_torch.optim.adamw_update`): the state returned holds the
same tensors as the state given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.train.losses import cross_entropy

Params = dict


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the port has no distributed layer yet: "
                                  "pass mesh=None")


def _no_compress(compress: bool) -> None:
    if compress:
        raise NotImplementedError("the port has no gradient compression "
                                  "yet: pass compress=False")


# ===========================================================================
# train state
# ===========================================================================

@dataclasses.dataclass
class TrainState:
    params: Params
    opt: Params                 # {"m": ..., "v": ...}, fp32
    step: torch.Tensor          # int32 scalar
    ef_error: Params | None = None    # error-feedback state (compression)


def init_train_state(cfg, generator: torch.Generator | int = 0, *,
                     device: torch.device | str | None = None,
                     compress: bool = False) -> TrainState:
    """Parameters from ``generator`` (a seed or a ``torch.Generator``) on
    ``device`` (None: the CUDA card), zero fp32 moments, step 0."""
    _no_compress(compress)
    params = M.init_params(cfg, generator, device=device)
    step = torch.zeros((), dtype=torch.int32,
                       device=M.tree_leaves(params)[0].device)
    return TrainState(params=params, opt=init_opt_state(params), step=step)


# ===========================================================================
# train step
# ===========================================================================

def make_loss_fn(cfg) -> Callable:
    """``loss_fn(params, batch) -> (loss, aux)``: next-token cross entropy
    of ``forward`` with a 1e-4 z-loss, as the reference's; a MoE config
    adds ``router_aux_weight`` times the layers' summed router aux loss
    and reports that sum as ``moe_aux``."""
    def loss_fn(params: Params, batch: dict):
        logits, moe_aux = M.forward(cfg, params, batch)
        labels = batch["tokens"][:, 1:]
        loss, aux = cross_entropy(logits[:, :-1], labels, z_loss=1e-4)
        if cfg.is_moe:
            loss = loss + cfg.router_aux_weight * moe_aux
            aux["moe_aux"] = moe_aux
        return loss, aux

    return loss_fn


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def _tree_like(like: Params, leaves) -> Params:
    """``leaves`` (in ``tree_leaves`` order) in the nesting of ``like``."""
    it = iter(leaves)
    return M.tree_map(lambda _: next(it), like)


def make_train_step(cfg, mesh=None, opt_cfg: OptConfig | None = None, *,
                    accum: int = 1, compress: bool = False
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    """The train step: ``step_fn(state, batch) -> (state, metrics)``.

    With ``accum > 1`` the batch splits into ``accum`` microbatches in
    order; their fp32 gradients are summed ``/ accum`` and the loss is
    averaged, as the reference's ``lax.scan`` does."""
    _no_mesh(mesh)
    _no_compress(compress)
    opt_cfg = opt_cfg if opt_cfg is not None else OptConfig()
    loss_fn = make_loss_fn(cfg)

    def fp32_grads(loss: torch.Tensor, leaves: list):
        """Each leaf's gradient in fp32, in order (zeros where none
        reaches the leaf); the low-precision one goes as its copy comes,
        so at most one leaf's fp32 copy is in flight beside them."""
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for i, p in enumerate(leaves):
            g, grads[i] = grads[i], None
            yield (torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) if g is None else g.float())

    def step_fn(state: TrainState, batch: dict
                ) -> tuple[TrainState, dict]:
        leaves = M.tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        if accum == 1:
            loss, aux = loss_fn(state.params, batch)
            grads = list(fp32_grads(loss, leaves))
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(batch, accum):
                l, _ = loss_fn(state.params, mb)
                for i, g in enumerate(fp32_grads(l, leaves)):
                    grads[i] = grads[i] + g / accum
                loss = loss + l.detach() / accum
            aux = {}
        new_params, new_opt, om = adamw_update(
            _tree_like(state.params, grads), state.opt, state.params,
            state.step, opt_cfg)
        metrics = {"loss": loss.detach(), **om,
                   **{k: v.detach() for k, v in aux.items()
                      if v.ndim == 0}}
        return TrainState(new_params, new_opt, state.step + 1,
                          state.ef_error), metrics

    return step_fn


# ===========================================================================
# serving steps
# ===========================================================================

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
