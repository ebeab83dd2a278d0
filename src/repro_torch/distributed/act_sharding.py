"""The hooks model code calls so that it stays mesh-agnostic: the port's
counterpart of ``repro.distributed.act_sharding``, and two more for the
weights.

* ``constrain(x, kind)`` at layer boundaries: a sharding *policy*
  (installed by the step builders through :func:`use_policy`) maps the
  semantic kind to a placement (``sharding.ActivationPolicy``).
* ``gathered(tree, *path, period=)`` where a layer's weights are used:
  under a mesh step's gatherer (:func:`use_gather`) the leaves come back
  whole, gathered from their shards; ``path`` is the subtree's dict path
  in the parameter tree and ``period`` its index in a stacked ``layers``
  tree, so the gatherer knows each leaf's spec.
* ``placed(t)`` on every parameter leaf an init function makes: under
  :func:`use_init` the leaf becomes this rank's shard as soon as it is
  drawn, so a sharded init never holds more than one whole leaf.
* ``tp_split(kind, shape, dim)`` where a layer computes: whether the
  rules split dim ``dim`` of an activation kind or a weight leaf over
  ``model`` here, with the group, rank and size to compute its slice
  with (``sharding.ActivationPolicy.tp_split``); ``kv_seq_len(n)`` the
  whole length of a decode step's KV cache shard of ``n`` slots.

Outside any of them (CPU runs, serving without a mesh) each hook returns
its argument unchanged.

Kinds used by the model zoo:
  residual    (B, S, D)      ffn_hidden (B, S, F)      logits   (B, S, V)
  heads_q     (B, H, S, Dh)  heads_kv   (B, Hk, S, Dh) kv_cache (B, S, Hk, Dh)
  moe_buf     (E, C, D)      moe_hidden (E, C, F)      rec_state (B, D)
  moe_gbuf    (G, E, C, D)   moe_ghidden (G, E, C, F)  moe_gout (G, E, C, D)
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

Policy = Callable[[Any, str], Any]

_POLICY: contextvars.ContextVar[Policy | None] = contextvars.ContextVar(
    "repro_torch_act_sharding_policy", default=None)
_GATHER: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "repro_torch_param_gather", default=None)
_INIT: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "repro_torch_param_init", default=None)


@contextlib.contextmanager
def _using(var: contextvars.ContextVar, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def use_policy(policy: Policy | None):
    return _using(_POLICY, policy)


def current_policy() -> Policy | None:
    return _POLICY.get()


def constrain(x, kind: str):
    policy = _POLICY.get()
    if policy is None:
        return x
    return policy(x, kind)


def tp_split(kind, shape: tuple[int, ...], dim: int):
    """A ``sharding.TP`` where this context's policy splits dim ``dim``
    of a ``shape`` tensor of ``kind`` (an activation kind, or a weight's
    dict path such as ``("attn", "wq", "w")``) over a ``model`` axis of
    size > 1; None outside a mesh step and where the dim is whole."""
    split = getattr(_POLICY.get(), "tp_split", None)
    return None if split is None else split(kind, shape, dim)


def tp_size() -> int:
    """The ``model`` axis's size under this context's policy (1 outside a
    mesh step)."""
    return getattr(_POLICY.get(), "model_size", 1)


def kv_seq_len(n: int) -> int:
    """The whole sequence length of a KV cache whose local shard holds
    ``n`` slots (``n`` outside a mesh decode step)."""
    return getattr(_POLICY.get(), "kv_seq", {}).get(n, n)


def use_gather(gather: Callable | None):
    """``gather(tree, path, period)`` for :func:`gathered` in this
    context."""
    return _using(_GATHER, gather)


def gathered(tree, *path: str, period: int | None = None):
    gather = _GATHER.get()
    if gather is None:
        return tree
    return gather(tree, tuple(path), period)


def current_hooks() -> Callable:
    """A context-manager factory that installs this context's policy and
    gatherer again: for work that runs later, outside this context or on
    another thread (remat's recomputation in the backward pass)."""
    policy, gather = _POLICY.get(), _GATHER.get()

    @contextlib.contextmanager
    def hooks():
        with use_policy(policy), use_gather(gather):
            yield

    return hooks


def use_init(place: Callable | None):
    """``place(leaf)`` for :func:`placed` in this context."""
    return _using(_INIT, place)


def placed(t):
    place = _INIT.get()
    return t if place is None else place(t)
