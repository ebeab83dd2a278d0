"""The collectives a mesh step runs, over the groups of a ``DeviceMesh``:
placing a tree on the mesh, gathering a shard back to its whole tensor,
reducing a gradient over the data-parallel axes, the tensor-parallel
pairs over ``model``, and the autograd-aware all-gather and mean over
the data-parallel axes that the MoE layer uses.

The batch splits over the dp axes (``pod``, ``data``) and the work over
``model``, Megatron-style, as the reference's rules lay it out: a weight
is gathered over the dp axes where the model uses it (FSDP,
:class:`ParamGather`, through ``act_sharding.gathered``) and keeps its
``model`` shard, and the model computes its slice of every dim the rules
split over ``model`` (``sharding.tp_split``), joining the slices with
:func:`copy_in`, :func:`reduce_out`, :func:`gather_along` and
:func:`split_along`.  The recurrent mixers (RG-LRU, mLSTM, sLSTM)
compute on their shards too: no weight crosses ``model``, only
activations do.  A weight's gradient goes back, in fp32, as
the mean over the dp group of this rank's ``model`` shard of it: a
reduce-scatter over a dp axis that shards the weight, an all-reduce over
one that does not.  A mesh dim of size 1 runs no collective.

Every function takes placements as ``sharding.to_placements`` gives
them: one per mesh dim, ``Shard(d)`` or ``Replicate()``, a dim sharded
over several mesh dims split in the mesh's order.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from .sharding import TP, NamedSharding, dp_axes, map_with_path

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# ---------------------------------------------------------------------------
# one tensor along one mesh dim
# ---------------------------------------------------------------------------

def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _all_gather(out, src, group=group)
    return out.movedim(0, dim)


def _scatter_sum_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, each rank keeping its chunk along
    ``dim``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim)


def _dims(mesh):
    """(index, name, size) of every mesh dim, in order."""
    return [(i, n, s) for i, (n, s) in
            enumerate(zip(mesh.mesh_dim_names, mesh.shape))]


def dp_dims(mesh) -> tuple[int, ...]:
    """Indices of the mesh dims the batch splits over."""
    dp = dp_axes(mesh)
    return tuple(i for i, n, _ in _dims(mesh) if n in dp)


def dp_size(mesh) -> int:
    size = 1
    for i in dp_dims(mesh):
        size *= mesh.shape[i]
    return size


def dp_rank(mesh) -> int:
    """This rank's coordinate over the dp axes, row-major (pod-major)."""
    coord = mesh.get_coordinate()
    r = 0
    for i in dp_dims(mesh):
        r = r * mesh.shape[i] + coord[i]
    return r


# ---------------------------------------------------------------------------
# shards and whole tensors
# ---------------------------------------------------------------------------

def non_dp_dims(mesh) -> tuple[int, ...]:
    return tuple(i for i in range(mesh.ndim) if i not in dp_dims(mesh))


def shard_of(full: torch.Tensor, placements, mesh, only=None
             ) -> torch.Tensor:
    """This rank's shard of ``full`` over the mesh dims that shard it (or
    over those of them in ``only``): a view, ``full`` itself where none
    of size > 1 does."""
    coord = mesh.get_coordinate()
    x = full
    for (i, _, n), pl in zip(_dims(mesh), placements):
        if isinstance(pl, Shard) and n > 1 and (only is None or i in only):
            size = x.shape[pl.dim] // n
            x = x.narrow(pl.dim, coord[i] * size, size)
    return x


def gather_full(x: torch.Tensor, placements, mesh, only=None
                ) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x``, gathered over the
    mesh dims that shard it (or over those of them in ``only``); ``x``
    itself where none of size > 1 does."""
    out = x
    for (i, _, n), pl in reversed(list(zip(_dims(mesh), placements))):
        if isinstance(pl, Shard) and n > 1 and (only is None or i in only):
            out = _gather_dim(out, mesh.get_group(i), pl.dim)
    return out if out is x else out.contiguous()


def reduce_grad(g: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's share of the dp group's summed gradient: ``g`` is this
    rank's contribution to the gradient of its ``model`` shard (whole
    over the dp axes), the result its shard in the parameter's
    ``placements``."""
    for (i, _, n), pl in zip(_dims(mesh), placements):
        if n == 1 or i not in dp_dims(mesh):
            continue
        if isinstance(pl, Shard):
            g = _scatter_sum_dim(g, mesh.get_group(i), pl.dim)
        else:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.get_group(i))
    return g


def _unstacked(placements) -> tuple:
    """A stacked leaf's placements for one period slice (the leading
    period dim is never sharded)."""
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                 for p in placements)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def place(full: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``full`` (the same on every rank) as a DTensor under ``sharding``
    (a :class:`NamedSharding`, or a DTensor whose placements to take):
    each rank keeps a copy of its shard, so ``full`` can be freed."""
    if isinstance(sharding, DTensor):
        mesh, pl = sharding.device_mesh, sharding.placements
    else:
        mesh, pl = sharding.mesh, sharding.placements
    shard = shard_of(full, pl, mesh)
    if shard is not full:
        shard = shard.clone()
    return DTensor.from_local(shard, mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed under its sharding in ``shardings``."""
    return map_with_path(lambda _, t, sh: place(t, sh), tree, shardings)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole tensor, gathered; any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return gather_full(x.to_local(), x.placements, x.device_mesh)


def gather_tree(tree):
    return map_with_path(lambda _, t: full_tensor(t), tree)


def local_tree(tree):
    """Each DTensor leaf's local shard (same storage)."""
    return map_with_path(lambda _, t: t.to_local() if isinstance(t, DTensor) else t,
                tree)


def n_replicas(placements, mesh) -> int:
    """How many ranks hold each shard: the sizes of the mesh dims the
    placements leave replicated, multiplied."""
    r = 1
    for n, pl in zip(mesh.shape, placements):
        if not isinstance(pl, Shard):
            r *= n
    return r


def sharded_sumsq(leaves, placements, mesh) -> torch.Tensor:
    """The sum of every leaf's squares over the whole mesh, each shard
    counted once: a shard held by r ranks adds 1/r from each.  ``leaves``
    are local shards, ``placements`` theirs.  Summed leaf by leaf in
    order from 0, as ``optim.global_norm`` sums them."""
    total = 0
    for g, pl in zip(leaves, placements):
        s = torch.sum(g.float() ** 2)
        r = n_replicas(pl, mesh)
        total = total + (s / r if r > 1 else s)
    total = torch.as_tensor(total, dtype=torch.float32)
    if mesh.size() > 1:
        dist.all_reduce(total)
    return total


# ---------------------------------------------------------------------------
# weights gathered where they are used
# ---------------------------------------------------------------------------

class _GradSink:
    """Where a gathered weight's gradient goes: reduced to the shard's
    placement in fp32, divided by the dp size and by ``accum``, and added
    into the accumulator slot."""

    def __init__(self, mesh, accum: int):
        self.mesh = mesh
        self.divisor = dp_size(mesh)
        self.accum = accum

    def add(self, slot: torch.Tensor, g: torch.Tensor, placements) -> None:
        r = reduce_grad(g.float(), placements, self.mesh)
        if self.divisor > 1:
            r = r / self.divisor
        slot.add_(r / self.accum if self.accum > 1 else r)


class _Gather(torch.autograd.Function):
    """shard → the weight gathered over the dp dims; the backward hands
    the gradient of this rank's ``model`` shard to the sink (the weight
    itself takes no gradient).  ``anchor`` is a scalar that requires
    grad, so that the node joins the graph.  The node holds the sink and
    the slot, never the gatherer: the gatherer caches this node's
    outputs, and a reference cycle through them would keep every
    accumulator alive until the cyclic collector ran."""

    @staticmethod
    def forward(ctx, anchor, shard, placements, sink, slot):
        ctx.placements, ctx.sink, ctx.slot = placements, sink, slot
        full = gather_full(shard, placements, sink.mesh,
                           only=dp_dims(sink.mesh))
        return shard.detach() if full is shard else full

    @staticmethod
    def backward(ctx, g):
        ctx.sink.add(ctx.slot, g, ctx.placements)
        return None, None, None, None, None


class ParamGather:
    """The gatherer a mesh step installs (``act_sharding.use_gather``).

    ``placements`` maps each leaf's dict path to its placements (of the
    whole leaf; a period slice drops the stacked lead dim).  Each leaf
    is gathered over the dp axes and keeps its ``model`` shard, which
    the model computes with.  With ``grads`` (path → fp32 accumulator
    shaped like the local shard) each gathered weight's gradient is
    added there, reduced over the dp group and divided by ``dp_size *
    accum``; without it (serving), weights are gathered with no
    autograd.  A leaf outside the layer stacks is gathered once per
    gatherer and reused (the tied embedding's two uses then share one
    gradient, summed as autograd sums a leaf's).
    """

    def __init__(self, mesh, placements: dict, grads: dict | None = None,
                 accum: int = 1):
        self.mesh = mesh
        self.placements = placements
        self.grads = grads
        self.sink = _GradSink(mesh, accum)
        self.anchor = (torch.zeros((), requires_grad=True)
                       if grads is not None else None)
        self.seen: set = set()
        self._cache: dict = {}

    def __call__(self, tree, path: tuple, period: int | None):
        if period is None and path in self._cache:
            return self._cache[path]

        def one(sub, t):
            full_path = (*path, *sub)
            pl = self.placements[full_path]
            if period is not None:
                pl = _unstacked(pl)
            self.seen.add(full_path)
            if self.grads is None:
                return gather_full(t, pl, self.mesh, only=dp_dims(self.mesh))
            slot = self.grads[full_path]
            if period is not None:
                slot = slot[period]
            return _Gather.apply(self.anchor, t, pl, self.sink, slot)

        out = map_with_path(one, tree)
        if period is None:
            self._cache[path] = out
        return out

    def missing(self, leaves: dict) -> list:
        """Paths of non-empty leaves the forward never gathered."""
        return [p for p, t in leaves.items()
                if p not in self.seen and t.numel() > 0]


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``: the Megatron pair and its gathers
# ---------------------------------------------------------------------------

class _CopyIn(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """The sum over ``model``; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, tp):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=tp.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _own(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


class _GatherAlong(torch.autograd.Function):
    """Every ``model`` rank's slice concatenated along ``dim``; the
    backward is this rank's slice of the gradient where what follows
    runs replicated (every rank holds the whole gradient), or of the
    ranks' gradients summed (``partial``: each rank used a part)."""

    @staticmethod
    def forward(ctx, x, tp, dim, partial):
        ctx.tp, ctx.dim, ctx.partial = tp, dim, partial
        return _gather_dim(x, tp.group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _scatter_sum_dim(g, ctx.tp.group, ctx.dim)
        else:
            g = _own(g, ctx.tp, ctx.dim)
        return g.contiguous(), None, None, None


class _SplitAlong(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor replicated over
    ``model``; the backward gathers every rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.tp.group, ctx.dim).contiguous(), None, \
            None


class _ReduceScatterAlong(torch.autograd.Function):
    """The sum over ``model`` of every rank's part, each rank keeping its
    slice along ``dim``; the backward gathers every rank's slice of the
    gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _scatter_sum_dim(x, tp.group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.tp.group, ctx.dim).contiguous(), None, \
            None


def copy_in(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """The input of a column-parallel product, replicated over ``model``:
    ``x`` itself, whose gradient the backward all-reduces over ``model``
    (each rank's columns give a part of it)."""
    return x if tp is None else _CopyIn.apply(x, tp)


def reduce_out(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """The output of a row-parallel product: the sum of every ``model``
    rank's part, all-reduced; the gradient passes unchanged."""
    return x if tp is None else _ReduceOut.apply(x, tp)


def gather_along(x: torch.Tensor, tp: TP | None, dim: int = -1, *,
                 partial_grad: bool = False) -> torch.Tensor:
    """A column-parallel output made whole along ``dim`` for compute
    that runs replicated; its backward keeps this rank's slice of the
    gradient, summed over ``model`` first with ``partial_grad`` (where
    each rank computes with a part of the whole)."""
    return x if tp is None else _GatherAlong.apply(x, tp, dim % x.dim(),
                                                   partial_grad)


def split_along(x: torch.Tensor, tp: TP | None, dim: int = -1
                ) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor (the input
    of a row-parallel product); its backward gathers the gradient."""
    return x if tp is None else _SplitAlong.apply(x, tp, dim % x.dim())


def reduce_scatter_along(x: torch.Tensor, tp: TP | None, dim: int = -1
                         ) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every ``model``
    rank's part (a row-parallel product whose output the next op uses
    split); its backward gathers the gradient."""
    return x if tp is None else _ReduceScatterAlong.apply(x, tp,
                                                          dim % x.dim())


def all_reduce_(x: torch.Tensor, tp: TP | None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``x`` all-reduced over ``model`` in place, outside autograd (a
    running max, a decode step's partial sums)."""
    if tp is not None:
        dist.all_reduce(x, op=op, group=tp.group)
    return x


# ---------------------------------------------------------------------------
# activations over the dp group, under autograd
# ---------------------------------------------------------------------------

def _dp_groups(mesh):
    return [(mesh.get_group(i), mesh.shape[i]) for i in dp_dims(mesh)
            if mesh.shape[i] > 1]


class _DPGather(torch.autograd.Function):
    """Every dp rank's ``x`` concatenated along ``dim`` in dp order; the
    backward sums each rank's cotangents and returns its own slice."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        for group, _ in reversed(_dp_groups(mesh)):
            x = _gather_dim(x, group, dim)
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group, _ in _dp_groups(ctx.mesh):
            g = _scatter_sum_dim(g, group, ctx.dim)
        return g.contiguous(), None, None


class _DPMean(torch.autograd.Function):
    """The mean over the dp group; its backward is the mean of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _dp_mean(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _dp_mean(g.clone(), ctx.mesh), None


def _dp_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    for group, _ in _dp_groups(mesh):
        dist.all_reduce(x, group=group)
    n = dp_size(mesh)
    return x / n if n > 1 else x


def dp_all_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """``x`` (this rank's slice along ``dim``) → every dp rank's, under
    autograd."""
    return _DPGather.apply(x, mesh, dim) if _dp_groups(mesh) else x


def dp_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the dp group, under autograd."""
    return _DPMean.apply(x, mesh) if _dp_groups(mesh) else x


def dp_mean_(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the dp group, in place (no autograd)."""
    return _dp_mean(x, mesh)


def dp_rows(y: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a tensor that holds every dp rank's, dim 0."""
    n = dp_size(mesh)
    if n == 1:
        return y
    size = y.shape[0] // n
    return y[dp_rank(mesh) * size:(dp_rank(mesh) + 1) * size]


def paths_and_leaves(tree) -> dict[tuple, Any]:
    out: dict = {}
    map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out
