"""Losses of the port: the counterpart of ``repro.train.losses``.

Cross entropy in fp32 with an explicit logsumexp, an optional z-loss and
an optional 0/1 mask; it returns ``(loss, {"nll", "accuracy",
"tokens"})`` as the reference does.  On logits split by vocab over
``model`` (``tp``) it is vocab-parallel: the max and the sum of
exponentials are all-reduced, the label's logit is picked on the rank
that holds it, and the argmax is the first index of the global max, as
``argmax`` over the whole vocab takes it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *, z_loss: float = 0.0,
                  tp=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean token NLL (+ ``z_loss * lse**2``) of ``logits`` (B, S, V)
    against integer ``labels`` (B, S), over the tokens ``mask`` (B, S)
    keeps (None: all of them).  With ``tp`` (a ``sharding.TP``) the
    logits are this rank's slice of a vocab split over ``model``."""
    lg = logits.float()
    labels = labels.long()
    if tp is None:
        lse = torch.logsumexp(lg, dim=-1)                   # (B, S)
        pick = torch.gather(lg, -1, labels[..., None])[..., 0]
    else:
        n = lg.shape[-1]
        mx = C.all_reduce_(lg.detach().amax(-1), tp, C.dist.ReduceOp.MAX)
        sum_exp = C.reduce_out(torch.exp(lg - mx[..., None]).sum(-1), tp)
        lse = mx + torch.log(sum_exp)
        local = labels - tp.rank * n
        mine = (local >= 0) & (local < n)
        got = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        pick = C.reduce_out(torch.where(mine, got, 0.0), tp)
    nll = lse - pick
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (torch.ones_like(nll) if mask is None else mask.float())
    tot = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / tot
    with torch.no_grad():
        acc = ((_argmax(lg, tp) == labels) * mask).sum() / tot
    return loss, {"nll": loss, "accuracy": acc, "tokens": tot}


def _argmax(lg: torch.Tensor, tp) -> torch.Tensor:
    """The index of the first maximum over the vocab, ``lg`` this rank's
    slice of it under ``tp``."""
    if tp is None:
        return lg.argmax(-1)
    best, at = lg.max(-1)
    top = C.all_reduce_(best.clone(), tp, C.dist.ReduceOp.MAX)
    n = lg.shape[-1]
    first = torch.where(best == top, at + tp.rank * n, tp.size * n)
    return C.all_reduce_(first, tp, C.dist.ReduceOp.MIN)
