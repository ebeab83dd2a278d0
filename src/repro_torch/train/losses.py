"""Losses of the port: the counterpart of ``repro.train.losses``.

Cross entropy in fp32 with an explicit logsumexp, an optional z-loss and
an optional 0/1 mask; it returns ``(loss, {"nll", "accuracy",
"tokens"})`` as the reference does.
"""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, *, z_loss: float = 0.0
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean token NLL (+ ``z_loss * lse**2``) of ``logits`` (B, S, V)
    against integer ``labels`` (B, S), over the tokens ``mask`` (B, S)
    keeps (None: all of them)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                       # (B, S)
    pick = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - pick
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (torch.ones_like(nll) if mask is None else mask.float())
    tot = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / tot
    with torch.no_grad():
        acc = ((lg.argmax(-1) == labels) * mask).sum() / tot
    return loss, {"nll": loss, "accuracy": acc, "tokens": tot}
