"""Plain PyTorch versions of the port's kernels.

Each function is the ground truth its CUDA kernel is held against
(``chip_smoke.py`` on the card, ``tests/test_torch_kernels.py`` against
``repro.kernels.ref`` on the CPU), and what a kernel wrapper runs when the
tensor it was given lies on the CPU.  ``mlp`` materializes the hidden
tensor exactly like the paper's unfused schedule.  Products accumulate in
fp32 (inputs upcast; a bf16 x bf16 product is exact in fp32), matching
``preferred_element_type=float32`` in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
    "identity": lambda x: x,
}

# activation codes of the CUDA kernels (csrc/common.cuh: rt::act)
ACT_CODES = {"gelu": 0, "gelu_exact": 1, "silu": 2, "relu": 3,
             "identity": 4}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# GEMM family
# ---------------------------------------------------------------------------

def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def gemm_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
             *, act: str = "gelu") -> torch.Tensor:
    """The paper's benchmark op: ``act(x @ w + b)``."""
    h = torch.matmul(x.float(), w.float())
    if b is not None:
        h = h + b.float()
    return act_fn(act)(h).to(x.dtype)


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        wg: torch.Tensor | None = None, b1: torch.Tensor | None = None,
        b2: torch.Tensor | None = None, *, act: str = "gelu") -> torch.Tensor:
    """Layer-per-layer MLP (materializes the hidden tensor)."""
    xf = x.float()
    h = torch.matmul(xf, w1.float())
    if b1 is not None:
        h = h + b1.float()
    h = act_fn(act)(h)
    if wg is not None:
        h = h * torch.matmul(xf, wg.float())
    y = torch.matmul(h.to(x.dtype).float(), w2.float())
    if b2 is not None:
        y = y + b2.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + causal + local window)
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, Dh), k/v (B, Hk, Tk, Dh) → (B, Hq, Tq, Dh).

    A row with every key masked (a local window) gives zeros, not NaN."""
    b, hq, tq, dh = q.shape
    hk, tk = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hk}")
    group = hq // hk
    qg = q.reshape(b, hk, group, tq, dh).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * dh ** -0.5
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, hq, tq, dh).to(q.dtype)
