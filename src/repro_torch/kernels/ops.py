"""Public kernel API of the port: the dispatch.

Every op here but ``gemm_act`` (which has only the first: no caller asks
for its plain version on the card):
  * with ``backend='auto'`` calls the kernel wrapper, which launches the
    CUDA kernel for a CUDA tensor and runs the plain version for a CPU
    tensor — the decision is the tensor's device, nothing else;
  * with ``backend='ref'`` runs the plain PyTorch version
    (:mod:`repro_torch.kernels.ref`): the layer-per-layer baseline.

``attention``, ``rg_lru`` and ``mlstm`` are differentiable either way:
both backends go through one ``torch.autograd.Function`` each
(:func:`repro_torch.kernels.flash_attention.attention`,
:func:`repro_torch.kernels.rg_lru.rg_lru_scan`,
:func:`repro_torch.kernels.mlstm.mlstm_scan`), whose backward is the
backward kernel on the card and the plain gradient with ``'ref'`` or on
the CPU.  The other kernels have no backward yet: on a CUDA tensor that
needs a gradient their wrappers raise.

Each kernel picks its launch from its shapes in pure Python, its
``schedule``: the tile widths and the split-K of ``gemm`` and
``gemm_act`` (one tile loop, whose shared-memory footprint the registry
qualifies them on), the query tile height and ring depth of
``flash_attention``, the M tile, F slice, hidden chunk and ring depth of
the fused MLP within ``target``'s fast level (one kernel that sums its
F-slice partials itself, in a fixed order), the channel tile and chunk
of the RG-LRU scan and the ring depth of the mLSTM scan.
"""
from __future__ import annotations

from typing import Literal

from repro_torch.core import hw as hwlib

from . import flash_attention as _flash
from . import fused_mlp as _fused
from . import gemm as _gemm
from . import gemm_act as _gemm_act
from . import mlstm as _mlstm
from . import ref as _ref
from . import rg_lru as _rg_lru

Backend = Literal["auto", "ref"]


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "ref"):
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")


def gemm(x, w, *, backend: Backend = "auto"):
    _check_backend(backend)
    if backend == "ref":
        return _ref.gemm(x, w)
    return _gemm.gemm(x, w)


def gemm_act(x, w, b=None, *, act: str = "gelu"):
    """The paper's benchmark op: ``act(x @ w + b)``.  It has no
    ``backend``: its plain version runs for CPU tensors only."""
    return _gemm_act.gemm_act(x, w, b, act=act)


def fused_mlp(x, w1, w2, wg=None, b1=None, b2=None, *, act: str = "gelu",
              backend: Backend = "auto",
              target: hwlib.Target | None = None):
    """Full fused MLP; ``x`` may have leading batch dims (flattened)."""
    _check_backend(backend)
    if backend == "ref":
        return _ref.mlp(x, w1, w2, wg, b1, b2, act=act)
    *lead, m, k = x.shape
    y = _fused.fused_mlp(x.reshape(-1, k).contiguous(), w1, w2, wg, b1, b2,
                         act=act, target=target)
    return y.reshape(*lead, m, w2.shape[1])


# The plain path's attention schedule: 'naive' materialises the (Tq, Tk)
# scores (the layer-per-layer baseline); 'blockwise' runs
# ref.attention_blockwise, the flash schedule in plain ops, from
# ``min_len`` keys up.  The dry-run's --opt sets it
# (launch/dryrun.py:apply_opt_level).
_PLAIN_ATTN = {"mode": "naive", "min_len": 2048}


def set_plain_attention(mode: str, *, min_len: int = 2048) -> None:
    """The plain path's attention schedule, for every later
    :func:`attention` call that runs plain PyTorch (CPU tensors, fake
    tensors on the CPU, or ``backend='ref'``): ``'naive'`` or
    ``'blockwise'`` from ``min_len`` keys up.  A CUDA tensor launches the
    flash kernel whatever the mode.  The reference's
    ``repro.kernels.ops.set_xla_attention``."""
    if mode not in ("naive", "blockwise"):
        raise ValueError(f"mode must be 'naive' or 'blockwise', got "
                         f"{mode!r}")
    _PLAIN_ATTN["mode"] = mode
    _PLAIN_ATTN["min_len"] = int(min_len)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, backend: Backend = "auto"):
    """Attention, differentiable.  On the plain path under
    ``set_plain_attention('blockwise')`` with at least ``min_len`` keys
    it runs :func:`ref.attention_blockwise` with key blocks of
    ``max(block_kv(head_dim), 1024)``: the reference plans that block
    with ``plan_attention_blocks`` for a target; the port's flash key
    tile depends on the head dim alone (``flash_attention.block_kv``), so
    no target enters."""
    _check_backend(backend)
    if _PLAIN_ATTN["mode"] == "blockwise" \
            and k.shape[2] >= _PLAIN_ATTN["min_len"] \
            and _flash._plain(backend == "ref", q, k, v):
        return _ref.attention_blockwise(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_k=max(_flash.block_kv(q.shape[3]), 1024))
    return _flash.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, q_offset=q_offset,
                            plain=backend == "ref")


def rg_lru(x, a, h0=None, *, backend: Backend = "auto"):
    """RG-LRU scan: (all h in ``x.dtype``, final h in fp32)."""
    _check_backend(backend)
    return _rg_lru.rg_lru_scan(x, a, h0, plain=backend == "ref")


def mlstm(q, k, v, i_pre, f_pre, *, return_state: bool = False,
          chunk: int = 0, backend: Backend = "auto"):
    """Stabilized mLSTM scan: h in ``q.dtype`` and, with
    ``return_state``, the final ``{"C", "n", "m"}`` in fp32; h is
    differentiable.  The kernel writes the state itself, so serving's
    prefill runs it too (the reference sends ``return_state`` to its plain
    scan).  ``chunk > 0`` is ``cfg.mlstm_chunk``, the reference's
    time-chunked rematerialised scan for training: for a CPU tensor, or
    with ``backend='ref'``, h comes from ``ref.mlstm_scan_chunked``
    exactly as the reference computes it; on the card the kernel's
    Function already keeps only its chunks' start states, at its own
    chunk length, and ``chunk`` changes nothing.  Otherwise ``'ref'``
    runs the plain Function on any device."""
    _check_backend(backend)
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            i_pre.contiguous(), f_pre.contiguous())
    plain = backend == "ref" or all(x.device.type == "cpu" for x in args)
    if chunk and not return_state and plain:
        return _ref.mlstm_scan_chunked(*args, chunk=chunk)
    return _mlstm.mlstm_scan(*args, return_state=return_state,
                             plain=backend == "ref")
