"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule: the counterpart of ``repro.optim.adamw``.

The moments are fp32.  The schedule, the clip factor and the bias
corrections are fp32 tensors on the parameters' device, computed as the
reference computes them, not Python floats.  :func:`adamw_update`
updates the moments and the parameters in place (the reference returns
new trees): at llama3.2-3b's full width a second copy of the fp32
moments would be 25.7 GB more.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = dict[str, Any]

# leaf names and parent names whose parameters take no weight decay
_NO_DECAY_LEAVES = ("b", "scale", "bias", "xgate", "lam", "conv_b")
_NO_DECAY_PARENTS = ("ln1", "ln2", "lnx", "norm", "final_norm", "enc_norm",
                     "head_norm")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``·peak; an fp32
    scalar tensor for an integer ``step`` tensor."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    floor = cfg.peak_lr * cfg.min_lr_ratio
    cos = floor + (cfg.peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, (*path, k))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_opt_state(params: Params) -> Params:
    """Zero fp32 moments ``{"m": ..., "v": ...}`` shaped like ``params``."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)

    return {"m": zeros(params), "v": zeros(params)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    leaves = [leaf for _, leaf in _leaves_with_path(tree)]
    total = sum(torch.sum(leaf.float() ** 2) for leaf in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _decay_mask(path: tuple[str, ...]) -> bool:
    """No weight decay on norms, biases, gates and 1-D parameters, keyed
    on the dict-key path as in the reference."""
    leaf = path[-1] if path else ""
    if leaf in _NO_DECAY_LEAVES:
        return False
    parent = path[-2] if len(path) > 1 else ""
    return parent not in _NO_DECAY_PARENTS


@torch.no_grad()
def adamw_update(grads: Params, opt_state: Params, params: Params,
                 step: torch.Tensor, cfg: OptConfig, *,
                 grad_norm: torch.Tensor | None = None
                 ) -> tuple[Params, Params, dict[str, torch.Tensor]]:
    """One AdamW step.  Returns ``(params, opt_state, {"grad_norm",
    "lr"})``: the trees given, updated in place, each new parameter cast
    back to its dtype.  ``grad_norm`` is before clipping; a caller whose
    trees hold shards passes the whole tree's (else it is
    :func:`global_norm` of ``grads``)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = lr_schedule(step, cfg)
    t = step.float() + 1.0
    bc1 = 1.0 - torch.tensor(cfg.b1, device=t.device) ** t
    bc2 = 1.0 - torch.tensor(cfg.b2, device=t.device) ** t
    for path, g in _leaves_with_path(grads):
        m, v, p = (_get(opt_state["m"], path), _get(opt_state["v"], path),
                   _get(params, path))
        g = g.float() * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        # u = (m / bc1) / (sqrt(v / bc2) + eps), each step rounded as the
        # reference rounds it, in place to hold fewer leaf-sized buffers
        u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if _decay_mask(path):
            u.add_(cfg.weight_decay * p.float())
        p.copy_(p.float().sub_(u.mul_(lr)).to(p.dtype))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
