"""Parameter and activation sharding rules (FSDP x TP 2-D layout): the
port's counterpart of ``repro.distributed.sharding``.

Layout on the production mesh, as the reference's:

  * ``model`` axis: tensor parallelism — attention heads, d_ff, vocab,
    expert dim (EP) where divisible.
  * ``data`` axis: FSDP — parameters sharded on the *other* matrix dim.
  * ``pod`` axis (multi-pod): pure data parallelism — parameters
    replicated across pods, batch sharded.

Dims are sharded **only when divisible** by the axis size (``_div``), so
no shard is ever padded.

A spec (:class:`P`) restates the reference's ``PartitionSpec``: one entry
per tensor dim, each ``None``, an axis name or a tuple of names.  The
rules run against any mesh-like object: a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``), or anything with ``.shape`` (name →
size) and ``.axis_names``, such as :class:`repro_torch.launch.mesh.
AbstractMesh`, which computes production-size specs with no process
group.  :class:`NamedSharding` turns a spec into DTensor placements: for
each mesh dim, ``Shard(d)`` on the tensor dim that names it, else
``Replicate()``; a tuple entry such as ``("pod", "data")`` shards that
one dim over both axes, in the mesh's order, so that each rank holds the
shard the reference's ``NamedSharding`` gives the same device.

The rule engine is name-based over the parameter tree's dict paths
(``models.model.init_params``); stacked layer leaves carry a leading
period dim, never sharded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

Params = dict[str, Any]


class TP(NamedTuple):
    """A dim split over the ``model`` mesh dim: that dim's process group,
    this rank's coordinate on it and its size (> 1)."""
    group: Any
    rank: int
    size: int


class P(tuple):
    """A partition spec, ``P(None, "model")``: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size, in the mesh's order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes the batch is sharded over (pod included when present)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape.get(a, 1)      # absent axes don't shard
    return n


def _div(mesh, dim: int, axes) -> Any:
    """``axes`` if ``dim`` divides evenly over them, else None (replicate).
    Singleton axis tuples collapse to the bare name."""
    if dim % axis_size(mesh, axes) != 0:
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of nested dicts
    (``rest``: trees of the same structure), in the same nesting."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=(*path, k))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_spec(names: tuple[str, ...], shape: tuple[int, ...], mesh,
                cfg) -> P:
    """The spec of one parameter leaf at dict path ``names``, e.g.
    ('layers', 'pos0', 'attn', 'wq', 'w').  Stacked leaves (under
    'layers' or 'enc_layers') keep their leading period dim whole."""
    fsdp = "data"           # FSDP axis: params replicated across pods
    tp = "model"
    stacked = names[0] in ("layers", "enc_layers")
    lead: tuple = (None,) if stacked else ()
    body = shape[1:] if stacked else shape
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    grand = names[-3] if len(names) >= 3 else ""

    def spec(*ax):
        return P(*lead, *ax)

    # ---- embeddings / head -------------------------------------------------
    if names[0] == "embed":
        return P(_div(mesh, shape[0], tp), None)            # (V, D)
    if names[0] == "lm_head":
        if leaf == "w":
            return P(_div(mesh, shape[0], fsdp), _div(mesh, shape[1], tp))
        return P(_div(mesh, shape[0], tp))                  # bias (V,)

    # ---- norms & scalars ---------------------------------------------------
    if parent in ("ln1", "ln2", "lnx", "norm", "head_norm", "final_norm",
                  "enc_norm") or names[-1] in ("xgate", "lam", "conv_b"):
        return spec(*([None] * len(body)))
    if leaf == "conv":                                       # (K, W) depthwise
        return spec(None, _div(mesh, body[-1], tp))

    # ---- MoE ----------------------------------------------------------------
    if grand == "moe" or parent == "moe":
        if parent == "router" or grand == "router":
            return spec(*([None] * len(body)))
        if leaf in ("w1", "wg", "w2") and len(body) == 3:  # (E,D,F)/(E,F,D)
            e = body[0]
            if e % axis_size(mesh, tp) == 0:                 # expert parallel
                return spec(tp, _div(mesh, body[1], fsdp), None)
            # TP inside each expert: shard d_ff (F); FSDP on d_model (D)
            if leaf == "w2":                                 # (E, F, D)
                return spec(None, tp, _div(mesh, body[2], fsdp))
            return spec(None, _div(mesh, body[1], fsdp), tp)

    # ---- generic 2-D matrices ----------------------------------------------
    if leaf == "w" and len(body) == 2:
        d_in, d_out = body
        # contraction-side matrices (wo, w2, down, out): TP on input dim
        if parent in ("wo", "w2", "down", "out"):
            return spec(_div(mesh, d_in, tp), _div(mesh, d_out, fsdp))
        return spec(_div(mesh, d_in, fsdp), _div(mesh, d_out, tp))
    if leaf == "w" and len(body) == 3:                     # blockdiag (H,dh,dh)
        return spec(None, None, _div(mesh, body[-1], tp))
    if leaf == "b":
        return spec(*([None] * (len(body) - 1)), _div(mesh, body[-1], tp))

    # fallback: replicate
    return spec(*([None] * len(body)))


def param_pspecs(params_shape: Params, mesh, cfg) -> Params:
    """Spec tree matching ``params_shape`` (leaves with ``.shape``: the
    ``meta`` tensors of ``models.model.param_shapes``, or real ones)."""
    return map_with_path(
        lambda path, leaf: _param_spec(path, tuple(leaf.shape), mesh, cfg),
        params_shape)


def param_shardings(params_shape: Params, mesh, cfg) -> Params:
    """:class:`NamedSharding` tree matching ``params_shape``."""
    return to_shardings(param_pspecs(params_shape, mesh, cfg), mesh)


# ---------------------------------------------------------------------------
# activation rules (the policy plugged into act_sharding.use_policy)
# ---------------------------------------------------------------------------

def activation_spec(kind: str, shape: tuple[int, ...], mesh) -> P | None:
    """The spec the reference's policy constrains an activation of
    ``kind`` and ``shape`` to; None for a kind it leaves alone."""
    dp = dp_axes(mesh)
    tp = "model"
    sh = shape
    if kind == "residual":              # (B, S, D)
        return P(_div(mesh, sh[0], dp), None, None)
    if kind in ("ffn_hidden", "logits"):    # (B, S, F) / (B, S, V)
        return P(_div(mesh, sh[0], dp), None, _div(mesh, sh[2], tp))
    if kind in ("heads_q", "heads_kv"):     # (B, H, S, Dh)
        return P(_div(mesh, sh[0], dp), _div(mesh, sh[1], tp), None, None)
    if kind == "kv_cache":              # (B, S, Hk, Dh): seq over model
        return P(_div(mesh, sh[0], dp), _div(mesh, sh[1], tp), None, None)
    if kind == "moe_buf":               # (E, C, D)
        return P(_div(mesh, sh[0], tp), _div(mesh, sh[1], dp), None)
    if kind == "moe_hidden":            # (E, C, F)
        e_sharded = sh[0] % axis_size(mesh, tp) == 0
        return P(_div(mesh, sh[0], tp), _div(mesh, sh[1], dp),
                 None if e_sharded else _div(mesh, sh[2], tp))
    if kind in ("moe_gbuf", "moe_gout"):    # (G, E, C, D): G over dp only
        return P(_div(mesh, sh[0], dp), None, None, None)
    if kind == "moe_ghidden":           # (G, E, C, F)
        e_sharded = sh[1] % axis_size(mesh, tp) == 0
        return P(_div(mesh, sh[0], dp), _div(mesh, sh[1], tp), None,
                 None if e_sharded else _div(mesh, sh[3], tp))
    if kind == "rec_state":             # (B, W)
        return P(_div(mesh, sh[0], dp), _div(mesh, sh[1], tp))
    return None


class ActivationPolicy:
    """Maps an activation kind to its spec on ``mesh``, and answers the
    model's question of which dims it computes split over ``model``
    (:meth:`tp_split`).  A DTensor is redistributed to the spec's
    placements; a rank-local tensor comes back unchanged: a mesh step
    splits the batch over dp before the model runs, and the model itself
    computes its slice of each dim the rules split over ``model``.  The
    MoE layers read the mesh from here to route over the dp group's
    tokens.  ``kv_seq`` maps the sequence length of a decode step's local
    KV cache shard to the cache's whole length (``make_decode_step``)."""

    def __init__(self, mesh, kv_seq: dict[int, int] | None = None):
        self.mesh = mesh
        self.kv_seq = kv_seq or {}

    def __call__(self, x, kind: str):
        if not isinstance(x, DTensor):
            return x
        spec = activation_spec(kind, tuple(x.shape), self.mesh)
        if spec is None:
            return x
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))

    @property
    def model_size(self) -> int:
        return mesh_shape(self.mesh).get("model", 1)

    def tp_split(self, kind, shape: tuple[int, ...], dim: int) -> TP | None:
        """:class:`TP` where the rules split dim ``dim`` of a ``shape``
        tensor over a ``model`` axis of size > 1, else None.  ``kind`` is
        an activation kind (:func:`activation_spec`) or a parameter
        leaf's dict path (:func:`_param_spec`), so that the compute and
        the stored layout come from the same rules."""
        sizes = mesh_shape(self.mesh)
        if sizes.get("model", 1) == 1:
            return None
        spec = (_param_spec(tuple(kind), tuple(shape), self.mesh, None)
                if isinstance(kind, tuple)
                else activation_spec(kind, tuple(shape), self.mesh))
        entry = None if spec is None else spec[dim]
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" not in axes:
            return None
        i = axis_names(self.mesh).index("model")
        return TP(self.mesh.get_group(i), self.mesh.get_coordinate()[i],
                  sizes["model"])


def make_activation_policy(mesh, cfg, kv_seq: dict[int, int] | None = None
                           ) -> ActivationPolicy:
    """The policy on ``mesh`` (the rules read no config field; ``cfg`` is
    the reference's signature)."""
    return ActivationPolicy(mesh, kv_seq)


# ---------------------------------------------------------------------------
# input / cache rules
# ---------------------------------------------------------------------------

def batch_pspecs(batch_shape: dict, mesh) -> dict:
    """tokens (B, S) and stub-frontend embeddings shard batch over dp."""
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        spec = [None] * len(v.shape)
        spec[0] = _div(mesh, v.shape[0], dp)
        out[k] = P(*spec)
    return out


def cache_pspecs(cache_shape: Params, mesh, cfg) -> Params:
    """Decode-state specs: KV caches (stacked (L, B, S, Hk, Dh)) shard
    batch over dp and the *sequence* over ``model``; recurrent states
    shard their feature dim over ``model``."""
    dp = dp_axes(mesh)
    tp = "model"

    def one(names, leaf):
        sh = tuple(leaf.shape)
        stacked = names[0] == "layers"
        lead: tuple = (None,) if stacked else ()
        body = sh[1:] if stacked else sh
        leafname = names[-1]
        if leafname in ("k", "v") and len(body) == 4:      # (B, S, Hk, Dh)
            return P(*lead, _div(mesh, body[0], dp), _div(mesh, body[1], tp),
                     None, None)
        if leafname == "C" and len(body) == 4:             # (B, H, Dh, Dh)
            return P(*lead, _div(mesh, body[0], dp), None, None,
                     _div(mesh, body[3], tp))
        if leafname in ("n",) and len(body) == 3:          # (B, H, Dh)
            return P(*lead, _div(mesh, body[0], dp), None,
                     _div(mesh, body[2], tp))
        if leafname == "conv" and len(body) == 3:          # (B, K-1, W)
            return P(*lead, _div(mesh, body[0], dp), None,
                     _div(mesh, body[2], tp))
        if len(body) == 2:                                 # (B, W) rec/slstm
            return P(*lead, _div(mesh, body[0], dp),
                     _div(mesh, body[1], tp))
        if len(body) == 1:                                 # (B,) scalars/m
            return P(*lead, _div(mesh, body[0], dp))
        return P(*lead, *([None] * len(body)))

    return map_with_path(one, cache_shape)


# ---------------------------------------------------------------------------
# specs as placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec``: for each mesh dim, ``Shard(d)`` on
    the tensor dim whose entry names it, else ``Replicate()``.  A tuple
    entry must list its axes in the mesh's order (so that DTensor's
    nested split is the reference's major-to-minor one)."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} names axis {names[i]!r} on "
                                 f"two dims")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of each device's shard of a ``shape`` tensor."""
        out = list(shape)
        sizes = list(mesh_shape(self.mesh).values())
        for n, pl in zip(sizes, self.placements):
            if isinstance(pl, Shard):
                if out[pl.dim] % n:
                    raise ValueError(f"dim {pl.dim} of {tuple(shape)} does "
                                     f"not split {n} ways")
                out[pl.dim] //= n
        return tuple(out)


def to_shardings(pspecs, mesh):
    """:class:`NamedSharding` for every spec in a tree of specs."""
    if isinstance(pspecs, P):
        return NamedSharding(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: to_shardings(v, mesh) for k, v in pspecs.items()}
    if dataclasses.is_dataclass(pspecs):
        return dataclasses.replace(pspecs, **{
            f.name: to_shardings(getattr(pspecs, f.name), mesh)
            for f in dataclasses.fields(pspecs)})
    if pspecs is None:
        return None
    raise TypeError(f"not a spec tree: {type(pspecs).__name__}")
