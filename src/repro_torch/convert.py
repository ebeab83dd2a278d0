"""Parameter trees from the JAX package into the port.

The reference's parameter tree (``repro.models.model.init_params``) and
the port's have the same nesting and the same leaf shapes (stacked
``layers`` leaves ``(n_periods, ...)``), so converting is leaf by leaf.
The caller turns the JAX arrays into numpy first (``np.asarray`` on each
leaf); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device: torch.device | str
                      ) -> torch.Tensor:
    """One array as a tensor on ``device``.  ``ml_dtypes`` bfloat16
    arrays (what ``np.asarray`` gives for a bf16 JAX array) travel as
    their ``uint16`` bits and are viewed back as ``torch.bfloat16``.  The
    data is copied: the tensor never aliases the (possibly read-only)
    array."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: dict[str, Any], device: torch.device | str
                      ) -> dict[str, Any]:
    """A nested dict of numpy arrays as the same nesting of tensors on
    ``device``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
        elif isinstance(v, np.ndarray):
            out[k] = tensor_from_numpy(v, device)
        else:
            raise TypeError(f"leaf {k!r} is {type(v).__name__}, not a "
                            f"numpy array")
    return out
