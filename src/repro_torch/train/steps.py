"""Step builders of the port: the counterparts of the reference's
``repro.train.steps``, the train step with gradient accumulation and the
two serving steps, with or without a mesh.

PyTorch runs eagerly, so a step is the plain function the reference
would hand to ``jax.jit``.  Without a mesh the train step takes
gradients with ``torch.autograd.grad`` over the parameter leaves and
casts them to fp32; a leaf that no gradient reaches (the empty ``(0,
...)`` stacks of a config with no whole period) counts as zeros.

With a mesh (a ``DeviceMesh``, ``repro_torch.launch.mesh``) the state's
leaves are DTensors in the reference's layout (:func:`state_pspecs`: the
moments and the error-feedback state follow their parameters).  Each
rank runs its rows of the batch (split over the dp axes by
``batch_pspecs``; ranks along ``model`` run the same rows) and its slice
of the work over ``model``, Megatron-style, as the reference's rules
split it (``models.layers``, ``models.moe``, the vocab in
``models.model`` and ``train.losses``): every weight is gathered over
the dp axes where the model uses it and keeps its ``model`` shard (the
recurrent mixers' too), and its gradient comes back in fp32 as the
mean over the dp group of this rank's shard
(``distributed.collectives.ParamGather``).  AdamW and the error feedback
then update each rank's shards in place; the gradient norm counts every
shard once.  The loss and the other metrics are means
over the dp group (``tokens`` a sum).

``compress=True`` applies int8 error-feedback compression to the reduced
gradients (``distributed.compression``), as the reference does, before
AdamW.

In both cases the AdamW update runs in place
(:func:`repro_torch.optim.adamw_update`): the state returned holds the
same tensors as the state given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.distributed import collectives as C
from repro_torch.distributed.act_sharding import (use_gather, use_init,
                                                  use_policy)
from repro_torch.distributed.compression import ef_compress_, init_error
from repro_torch.distributed.sharding import (NamedSharding, P, _div,
                                              batch_pspecs, cache_pspecs,
                                              dp_axes,
                                              make_activation_policy,
                                              param_pspecs, to_shardings)
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.train.losses import cross_entropy

Params = dict


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh is a torch.distributed DeviceMesh "
                        f"(repro_torch.launch.mesh.make_mesh), not "
                        f"{type(mesh).__name__}")


# ===========================================================================
# train state
# ===========================================================================

@dataclasses.dataclass
class TrainState:
    params: Params
    opt: Params                 # {"m": ..., "v": ...}, fp32
    step: torch.Tensor          # int32 scalar
    ef_error: Params | None = None    # error-feedback state (compression)


def _zeros_f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped and placed like ``t`` (a DTensor's: its shards)."""
    if isinstance(t, DTensor):
        return DTensor.from_local(
            torch.zeros(t.to_local().shape, dtype=torch.float32,
                        device=t.to_local().device),
            t.device_mesh, t.placements, run_check=False, shape=t.shape,
            stride=t.stride())
    return torch.zeros(t.shape, dtype=torch.float32, device=t.device)


def _init_sharded_params(cfg, generator, device, mesh) -> Params:
    """``M.init_params`` with each leaf placed on ``mesh`` as it is drawn
    (``act_sharding.placed``): the same draws from the same generator in
    the same order, so the shards are the unsharded init's bits, and at
    most one whole leaf is held.  A run on the ``meta`` device first finds
    which leaf each draw makes."""
    made: list = []
    with use_init(lambda t: made.append(t) or t):
        shapes = M.init_params(cfg, device="meta")
    path_of = {id(t): p for p, t in C.paths_and_leaves(shapes).items()}
    order = [path_of.get(id(t)) for t in made]
    if None in order or sorted(order) != sorted(path_of.values()):
        raise RuntimeError(f"{cfg.name}: the init's leaves and its placed() "
                           f"calls disagree")
    specs = C.paths_and_leaves(param_pspecs(shapes, mesh, cfg))
    todo = iter(order)
    with use_init(lambda t: C.place(t, NamedSharding(mesh,
                                                     specs[next(todo)]))):
        return M.init_params(cfg, generator, device=device)


def init_train_state(cfg, generator: torch.Generator | int = 0, *,
                     device: torch.device | str | None = None,
                     compress: bool = False, mesh=None) -> TrainState:
    """Parameters from ``generator`` (a seed or a ``torch.Generator``) on
    ``device`` (None: the CUDA card), zero fp32 moments (and error state
    with ``compress``), step 0.  With ``mesh`` every leaf is a DTensor
    in :func:`state_pspecs`' layout, each rank's shard of the unsharded
    init's bits."""
    _check_mesh(mesh)
    if mesh is None:
        params = M.init_params(cfg, generator, device=device)
        opt = init_opt_state(params)
        ef = init_error(params) if compress else None
    else:
        params = _init_sharded_params(cfg, generator, device, mesh)
        opt = {"m": M.tree_map(_zeros_f32, params),
               "v": M.tree_map(_zeros_f32, params)}
        ef = M.tree_map(_zeros_f32, params) if compress else None
    leaf = M.tree_leaves(C.local_tree(params))[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return TrainState(params=params, opt=opt, step=step, ef_error=ef)


def train_state_shapes(cfg, *, compress: bool = False) -> TrainState:
    """The train state on the ``meta`` device: shapes and dtypes only."""
    params = M.param_shapes(cfg)
    return TrainState(
        params=params, opt={"m": M.tree_map(_zeros_f32, params),
                            "v": M.tree_map(_zeros_f32, params)},
        step=torch.zeros((), dtype=torch.int32, device="meta"),
        ef_error=M.tree_map(_zeros_f32, params) if compress else None)


def state_pspecs(state_shape: TrainState, mesh, cfg) -> TrainState:
    """Spec tree of a train state: moments and error state follow their
    parameters, the step is replicated."""
    pspec = param_pspecs(state_shape.params, mesh, cfg)
    return TrainState(
        params=pspec, opt={"m": pspec, "v": pspec}, step=P(),
        ef_error=None if state_shape.ef_error is None else pspec)


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
        loss, aux = cross_entropy(logits[:, :-1], labels, z_loss=1e-4,
                                  tp=M.vocab_split(cfg))
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
    averaged, as the reference's ``lax.scan`` does.  With ``mesh`` the
    batch is this rank's rows (:func:`shard_batch`) and the state's
    leaves are DTensors (:func:`init_train_state` with ``mesh``)."""
    _check_mesh(mesh)
    opt_cfg = opt_cfg if opt_cfg is not None else OptConfig()
    loss_fn = make_loss_fn(cfg)
    policy = make_activation_policy(mesh, cfg) if mesh is not None else None

    def fp32_grads(loss: torch.Tensor, leaves: list):
        """Each leaf's gradient in fp32, in order (zeros where none
        reaches the leaf); the low-precision one goes as its copy comes,
        so at most one leaf's fp32 copy is in flight beside them."""
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for i, p in enumerate(leaves):
            g, grads[i] = grads[i], None
            yield (torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) if g is None else g.float())

    def local_grads(state: TrainState, batch: dict):
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
        return loss.detach(), aux, grads, None

    def mesh_grads(state: TrainState, batch: dict):
        dts = C.paths_and_leaves(state.params)
        local = {p: t.to_local() for p, t in dts.items()}
        placements = {p: t.placements for p, t in dts.items()}
        params = C.local_tree(state.params)
        grads = {p: torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for p, t in local.items()}
        micro = [batch] if accum == 1 else _split_microbatches(batch, accum)
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(local.values())).device)
        for mb in micro:
            gather = C.ParamGather(mesh, placements, grads, accum)
            with use_policy(policy), use_gather(gather):
                l, aux = loss_fn(params, mb)
            missing = gather.missing(local)
            if missing:
                raise RuntimeError(f"the forward used weights it did not "
                                   f"gather: {missing}")
            l.backward()
            loss = l.detach() if accum == 1 else loss + l.detach() / accum
        aux = {k: v.detach() for k, v in aux.items()} if accum == 1 else {}
        loss = C.dp_mean_(loss.clone(), mesh)
        for k, v in aux.items():
            if v.ndim == 0:
                v = C.dp_mean_(v.float().clone(), mesh)
                aux[k] = v * C.dp_size(mesh) if k == "tokens" else v
        return loss, aux, list(grads.values()), [placements[p]
                                                 for p in dts]

    def step_fn(state: TrainState, batch: dict
                ) -> tuple[TrainState, dict]:
        if mesh is None:
            loss, aux, grads, placements = local_grads(state, batch)
            params, opt = state.params, state.opt
            ef = None if state.ef_error is None else \
                M.tree_leaves(state.ef_error)
        else:
            loss, aux, grads, placements = mesh_grads(state, batch)
            params, opt = C.local_tree(state.params), C.local_tree(
                state.opt)
            ef = None if state.ef_error is None else \
                M.tree_leaves(C.local_tree(state.ef_error))
        if compress:
            if ef is None:
                raise ValueError("compress=True needs a state with an "
                                 "error-feedback state: init_train_state("
                                 "..., compress=True)")
            ef_compress_(grads, ef, reduce_max=mesh is not None)
        gnorm = None if mesh is None else torch.sqrt(
            C.sharded_sumsq(grads, placements, mesh))
        _, _, om = adamw_update(_tree_like(params, grads), opt, params,
                                state.step, opt_cfg, grad_norm=gnorm)
        metrics = {"loss": loss, **om,
                   **{k: v.detach() for k, v in aux.items()
                      if v.ndim == 0}}
        return TrainState(state.params, state.opt, state.step + 1,
                          state.ef_error), metrics

    return step_fn


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: its slice over the dp axes, as
    ``batch_pspecs`` places them.  The mesh steps split every batch, so
    rows that do not divide over the dp axes raise (the reference would
    replicate them)."""
    n = C.dp_size(mesh)
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} has {v.shape[0]} rows, which do "
                             f"not split over {n} data-parallel ranks")
    return {k: C.dp_rows(v, mesh) for k, v in batch.items()}


def train_step_shardings(cfg, mesh, state_shape: TrainState,
                         batch_shape: dict):
    """(in_shardings, out_shardings) of the train step: the state's and
    the batch's :class:`NamedSharding` trees in, the state's and one
    replicated sharding for the metrics out."""
    sspec = to_shardings(state_pspecs(state_shape, mesh, cfg), mesh)
    bspec = to_shardings(batch_pspecs(batch_shape, mesh), mesh)
    return (sspec, bspec), (sspec, NamedSharding(mesh, P()))


# ===========================================================================
# serving steps
# ===========================================================================

def _placements(tree) -> dict:
    return {p: t.placements for p, t in C.paths_and_leaves(tree).items()}


def _place_cache(cfg, mesh, cache: Params) -> Params:
    """A rank's cache (its rows) as DTensors in ``cache_pspecs``' layout.
    The model returns each KV cache whole over ``model``, and it is
    narrowed to this rank's slice of the sequence, as is an empty leaf
    (a stack with no whole period, made at the whole widths); every
    other leaf, the recurrent mixers' state, the model computed on its
    shard (``models.recurrent``), and it is placed as it is, after a
    check that its shape is ``cache_pspecs``' shard shape."""
    whole = M.whole_cache_shapes(cfg, cache, C.dp_size(mesh))
    specs = C.paths_and_leaves(cache_pspecs(whole, mesh, cfg))
    only = C.non_dp_dims(mesh)

    def one(path, t, full):
        sh = NamedSharding(mesh, specs[path])
        if _is_kv(path, t) or t.numel() == 0:
            t = C.shard_of(t, sh.placements, mesh, only=only).contiguous()
        elif tuple(t.shape) != sh.shard_shape(tuple(full.shape)):
            raise ValueError(
                f"cache leaf {path}: {tuple(t.shape)} is not its shard "
                f"{sh.shard_shape(tuple(full.shape))}")
        return DTensor.from_local(t, mesh, sh.placements, run_check=False,
                                  shape=full.shape, stride=full.stride())

    return C.map_with_path(one, cache, whole)


def make_prefill_step(cfg, mesh=None, *, max_seq: int | None = None,
                      plan=None):
    """Prefill step builder.  ``plan`` threads a (bucketed) prefill
    BlockPlan through the model's MLP dispatch; ``max_seq`` right-pads the
    returned caches for in-place decode appends.  The step takes an
    optional ``last_pos`` so bucket-padded prompts read their logits at
    the true last token.

    With ``mesh`` the step takes the DTensor parameters and this rank's
    rows of the batch (:func:`shard_batch`), gathers each layer's weights
    over the dp axes as it runs it and computes its slice over
    ``model``, and returns this rank's logits, whole over the vocab, and
    the cache as DTensors in ``cache_pspecs``' layout: the KV cache split
    by sequence over ``model`` (every KV head's, gathered where the heads
    split), the recurrent state by width, as each mixer returns it on
    its shard.  ``plan`` is made for whole-layer shapes: an MLP split
    over a ``model`` axis larger than 1 refuses one
    (``layers.mlp_layer``)."""
    _check_mesh(mesh)
    policy = make_activation_policy(mesh, cfg) if mesh is not None else None

    @torch.no_grad()
    def step_fn(params: Params, batch: dict, last_pos=None):
        if mesh is None:
            return M.prefill(cfg, params, batch, max_seq=max_seq, plan=plan,
                             last_pos=last_pos)
        gather = C.ParamGather(mesh, _placements(params))
        with use_policy(policy), use_gather(gather):
            logits, cache = M.prefill(cfg, C.local_tree(params), batch,
                                      max_seq=max_seq, plan=plan,
                                      last_pos=last_pos)
            logits = C.gather_along(logits, M.vocab_split(cfg))
        return logits, _place_cache(cfg, mesh, cache)

    return step_fn


def _is_kv(path: tuple, t) -> bool:
    """A KV cache leaf, (…, B, S, Hk, Dh): ``cache_pspecs`` splits its
    sequence over ``model``."""
    return path[-1] in ("k", "v") and \
        t.ndim - (path[0] == "layers") == 4


def _kv_seq(shards: dict) -> dict[int, int]:
    """Local sequence length → whole length of the KV leaves (DTensors)
    of a mesh decode step's cache."""
    out: dict[int, int] = {}
    for p, t in shards.items():
        if _is_kv(p, t):
            d = t.ndim - 3
            n, whole = t.to_local().shape[d], t.shape[d]
            if out.setdefault(n, whole) != whole:
                raise ValueError(f"two KV caches hold {n} slots a rank of "
                                 f"{out[n]} and {whole}: the decode step "
                                 f"cannot tell their layouts apart")
    return out


def make_decode_step(cfg, mesh=None, *, plan=None):
    """One token against a full cache.  ``pos`` may be a scalar or a
    per-row ``(B,)`` vector; ``plan`` threads the m=1 decode BlockPlan
    through the model's MLP dispatch.  The cache is updated in place.

    With ``mesh`` the parameters and the cache are DTensors (the cache
    from the mesh prefill step) and ``token`` this rank's rows.  The KV
    leaves stay split by sequence over ``model``: each rank attends to
    its slots and the rank that holds the new one writes it
    (``layers.attention_decode``).  Every leaf goes to the model as this
    rank's shard, and the recurrent mixers update their state there in
    place (``models.recurrent``): no state leaf is gathered.  The logits
    come back whole over the vocab.  ``plan`` as
    :func:`make_prefill_step` takes it."""
    _check_mesh(mesh)

    @torch.no_grad()
    def step_fn(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor):
        if mesh is None:
            return M.decode_step(cfg, params, token, cache, pos, plan=plan)
        gather = C.ParamGather(mesh, _placements(params))
        policy = make_activation_policy(
            mesh, cfg, _kv_seq(C.paths_and_leaves(cache)))
        with use_policy(policy), use_gather(gather):
            logits, _ = M.decode_step(cfg, C.local_tree(params), token,
                                      C.local_tree(cache), pos, plan=plan)
            logits = C.gather_along(logits, M.vocab_split(cfg))
        return logits, cache

    return step_fn


def decode_shardings(cfg, mesh, params_shape: Params, cache_shape: Params,
                     batch: int):
    """(params, cache, token (B, 1), pos) :class:`NamedSharding` trees of
    the decode step, the reference's."""
    dp = dp_axes(mesh)
    return (
        to_shardings(param_pspecs(params_shape, mesh, cfg), mesh),
        to_shardings(cache_pspecs(cache_shape, mesh, cfg), mesh),
        NamedSharding(mesh, P(_div(mesh, batch, dp), None)),
        NamedSharding(mesh, P()),
    )

