"""Op-level cost and memory count of one eager step: the port's
counterpart of ``repro.roofline.hlo_cost``.

The reference prices a compiled HLO module, walking ``while`` bodies
times their trip counts.  Eager PyTorch has no module: every aten op runs
as its own kernel, and a Python loop is already unrolled, so there is no
trip count to recover.  :class:`OpCost` is a ``TorchDispatchMode`` that
prices every op the step dispatches, by ``hlo_cost``'s categories:

  * FLOPs — matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``convolution``, ...) 2·|out|·K, also summed apart as
    ``matmul_flops``; arithmetic elementwise ops 1·|out|; transcendentals
    (``exp``, ``log``, ``tanh``, ``rsqrt``, ``sqrt``, ``sigmoid``,
    ``erf``, ``pow``, ``sin``, ``cos``, ``log1p``, ``expm1``, and the
    fused ``gelu``, ``silu``, softmaxes) 1·|out| in both ``flops`` and
    ``transcendentals``; reductions their operand's elements.  Views,
    metadata, casts, copies, indexing and gather/scatter count none.
  * bytes — a non-view op reads its operands and writes its results
    (there is no fusion boundary to price); an index read counts twice
    what it gathers and an indexed write twice what it writes (the
    reference's ``dynamic-slice`` and ``dynamic-update-slice``).  A view
    moves nothing.
  * collectives — the ``c10d`` and ``_c10d_functional`` ops by kind
    (all-gather, all-reduce, reduce-scatter, all-to-all, and ``send``
    as collective-permute), each its operand bytes, the reference's rule;
    they add operand and result bytes to ``bytes`` as well.
  * memory — live bytes by storage: every storage an op makes is counted
    from its first result until the storage is freed (a weakref
    finalizer), the step's arguments from the start.  The result has
    ``memory_analysis()``'s fields that have a meaning here:
    ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``alias_size_in_bytes`` (outputs sharing storage with an argument,
    such as parameters updated in place) and ``temp_size_in_bytes``
    (peak live minus arguments).  A tensor the step reads that is
    neither an argument nor made inside the step (a closure's) is not
    counted.

A tensor subclass other than ``FakeTensor`` (a ``DTensor``) is sent on
to its own dispatch, which runs its local ops back through this mode, so
every count is of local tensors: one rank's, one chip's.

A plain recurrence is a Python loop over time, thousands of steps of a
few ops each, and a fake tensor's op costs about 0.2 ms on the host.
The loops written with :func:`steps` are priced by trips where the mode
is made with ``loops=True`` (the dry-run's): four steps run and one
stands for the rest, in the forward as it runs and in the backward pass
through the autograd nodes it made (each op in a node's backward counts
as often as that node stands for); what that step keeps alive counts as
kept by the steps that did not run.  Every count is then the whole
loop's; the peak too, but for a step's locals: where a checkpoint's
recomputation stops inside a priced loop it may miss part of them, and
on a shape's first trace under ``FakeTensorMode`` a storage may stay
live a little longer (``tests/test_torch_roofline.py`` holds each case).
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import itertools
import math
import weakref
from typing import Any, Callable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot", "_scaled_mm", "convolution", "_convolution"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "tanh", "rsqrt", "sqrt",
    "sigmoid", "erf", "erfc", "erfinv", "pow", "sin", "cos", "tan", "log1p",
    "expm1", "atan", "asin", "acos", "sinh", "cosh", "gelu", "silu",
    "softplus", "logit"}
# transcendental per operand element (the output may be reduced)
_TRANSCENDENTAL_IN = {"_softmax", "_log_softmax", "logsumexp"}
_ARITH = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "fmax", "fmin", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "__and__",
    "__or__", "__xor__", "__lshift__", "__rshift__", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "trunc", "sign", "remainder",
    "fmod", "atan2", "reciprocal", "square", "masked_fill", "lerp",
    "addcmul", "addcdiv", "isnan", "isinf", "isneginf", "isposinf",
    "nan_to_num", "relu", "threshold", "hardtanh", "leaky_relu",
    "floor_divide", "xlogy", "copysign", "heaviside"}
_REDUCE = {
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "any", "all",
    "cumsum", "cumprod", "logcumsumexp", "count_nonzero", "nansum"}
# elementwise ops with a second overload that reduces
_ARITH_OVERLOADS = {"max": {"other"}, "min": {"other"}}
# index reads (dynamic-slice: twice the result) and indexed writes
# (dynamic-update-slice: twice the update, the argument given here)
_INDEX_READ = {"index", "index_select", "gather", "embedding",
               "take_along_dim", "take"}
_INDEX_WRITE = {"index_put": 2, "_index_put_impl": 2, "scatter": 3,
                "scatter_add": 3, "scatter_reduce": 3, "index_add": 3,
                "index_copy": 3, "slice_scatter": 1, "select_scatter": 1}
# ops that overwrite their first argument without reading it
_OVERWRITE = {"copy", "fill", "zero", "normal", "uniform", "random",
              "bernoulli", "exponential"}
# ops that move nothing (an allocation among them is still counted live)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh",
             "lift_fresh_copy", "_local_scalar_dense", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
             "set", "resize", "_has_compatible_shallow_copy_type"}

# c10d op → (kind, index of the operand argument, index of the result
# argument; None: the operand is the result).  A recv counts nothing (its
# matching send counts the bytes); a barrier moves nothing.
_C10D = {
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_coalesced_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "allreduce_": ("all-reduce", 0, None),
    "allreduce_coalesced_": ("all-reduce", 0, None),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, None),
}
_C10D_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D_SILENT = {"recv_", "recv_any_source_", "barrier", "monitored_barrier_",
                "wait_tensor"}


_DEVICE = torch.ops.prim.device.default


def _flat(x, acc: list) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, acc)
    return acc


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum_bytes(x) -> int:
    return sum(_nbytes(t) for t in _flat(x, []))


def _base(name: str) -> str:
    """The op's name without the in-place underscore."""
    if name.endswith("_") and not name.startswith("__"):
        return name[:-1]
    return name


def _contraction(name: str, args) -> int:
    """K of a matmul-family op."""
    if name in ("addmm", "baddbmm", "addmv"):
        return args[1].shape[-1]
    if name == "addbmm":
        return args[1].shape[0] * args[1].shape[2]
    if name in ("dot", "vdot"):
        return args[0].numel()
    if name in ("convolution", "_convolution"):
        return math.prod(args[1].shape[1:])
    return args[0].shape[-1]


def _is_plain(cls: type) -> bool:
    return cls is torch.Tensor or cls is torch.nn.Parameter \
        or issubclass(cls, FakeTensor)


@dataclasses.dataclass(frozen=True)
class _Rule:
    """How one op overload is priced (worked out once per overload)."""
    name: str
    kind: str                 # aten, collective, alloc (no bytes) or none
    flops: str | None = None  # matmul, trans, trans_in, arith, reduce
    mem: str = "rw"           # rw, read_index, write_index, overwrite
    update: int = 0           # write_index: the update's argument


def _make_rule(func) -> _Rule:
    name = func.overloadpacket.__name__
    if func.namespace in ("c10d", "_c10d_functional"):
        if name in _C10D_SILENT:
            return _Rule(name, "none")
        if (name not in _C10D if func.namespace == "c10d"
                else name not in _C10D_FUNCTIONAL):
            raise NotImplementedError(
                f"op_cost prices no {func.namespace}.{name}")
        return _Rule(name, "collective", mem=func.namespace)
    base = _base(name)
    if func.namespace != "aten" or func.is_view:
        return _Rule(name, "none")
    if base in _NO_BYTES:
        return _Rule(name, "alloc")
    if base in _MATMUL:
        flops = "matmul"
    elif base in _TRANSCENDENTAL:
        flops = "trans"
    elif base in _TRANSCENDENTAL_IN:
        flops = "trans_in"
    elif (base in _ARITH
          or func._overloadname in _ARITH_OVERLOADS.get(base, ())
          or base.endswith("_backward_data")
          or (base.endswith("_backward") and "embedding" not in base
              and "convolution" not in base)):
        flops = "arith"
    elif base in _REDUCE or base in _ARITH_OVERLOADS:
        flops = "reduce"
    else:
        flops = None
    if base in _INDEX_READ:
        return _Rule(name, "aten", flops, "read_index")
    if base in _INDEX_WRITE:
        return _Rule(name, "aten", flops, "write_index",
                     update=_INDEX_WRITE[base])
    return _Rule(name, "aten", flops,
                 "overwrite" if base in _OVERWRITE else "rw")


_COUNTS = ("flops", "matmul_flops", "transcendentals", "bytes",
           "collective_count", *COLLECTIVE_KINDS)
# the autograd engine's next node number (absent from older builds: there
# loops are not priced, they run whole)
_NEXT_NODE = getattr(torch._C._autograd, "_get_sequence_nr", None)
# the modes that price loops, innermost last
_PRICING: list["OpCost"] = []


class _NodeScale:
    """The factor each autograd node's backward is counted with: the
    product of the factors of the node-number ranges holding it (ranges
    nest or are disjoint, as the loops that make them)."""

    def __init__(self):
        self.cuts = [0]                 # segment i: [cuts[i], cuts[i + 1])
        self.factors = [1]

    def _split(self, x: int) -> int:
        i = bisect.bisect_right(self.cuts, x) - 1
        if self.cuts[i] != x:
            self.cuts.insert(i + 1, x)
            self.factors.insert(i + 1, self.factors[i])
            i += 1
        return i

    def scale(self, lo: int, hi: int, factor: int) -> None:
        if hi > lo:
            i, j = self._split(lo), self._split(hi)
            for k in range(i, j):
                self.factors[k] *= factor

    def __call__(self, node: int) -> int:
        return self.factors[bisect.bisect_right(self.cuts, node) - 1]


class OpCost(TorchDispatchMode):
    """Prices every op dispatched while it is active; see the module's
    docstring.  Enter it inside any ``FakeTensorMode``.  With
    ``loops=True`` the loops written with :func:`steps` are priced by
    trips, not run whole (for fake tensors only: the results are not the
    function's)."""

    def __init__(self, *, loops: bool = False):
        super().__init__()
        self.counts = dict.fromkeys(_COUNTS, 0)
        self.ops: dict[str, int] = {}
        self.loops = loops and _NEXT_NODE is not None
        self._scale = _NodeScale()
        self._rules: dict = {}
        # live storages by serial number, never reused (an ``id`` is, and
        # a priced loop compares the keys of one moment with another's)
        self._serial = itertools.count()
        self._key_of: dict[int, int] = {}       # id of a live storage
        self._live: dict[int, int] = {}
        self._phantom: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.since = 0          # the most live since a priced step began

    def __enter__(self):
        if self.loops:
            _PRICING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.loops:
            _PRICING.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------
    def _free(self, sid: int, key: int) -> None:
        if self._key_of.get(sid) == key:
            del self._key_of[sid]
        self.live -= self._live.pop(key, 0) + self._phantom.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now until it is freed (once),
        under a serial number taken now."""
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._key_of:
            return
        key = self._key_of[sid] = next(self._serial)
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        if self.live > self.since:
            self.since = self.live
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, sid, key)

    def _stand_for(self, keys, copies: int, step_peak: int) -> None:
        """Count each storage of ``keys`` as ``copies`` more of itself
        until it is freed: what the steps of a priced loop that did not
        run would keep.  The last step that ran, whose most live was
        ``step_peak``, then stands for the loop's last step."""
        extra = 0
        for key in keys:
            b = copies * self._live[key]
            self._phantom[key] = self._phantom.get(key, 0) + b
            extra += b
        self.live += extra
        self.peak = max(self.peak, step_peak + extra)

    # ------------------------------------------------------------------
    # pricing
    # ------------------------------------------------------------------
    def snapshot(self) -> tuple[dict, dict]:
        return dict(self.counts), dict(self.ops)

    def _add_since(self, snap: tuple[dict, dict], times: int) -> None:
        """Add ``times`` more of what was counted since ``snap``."""
        counts, ops = snap
        for k, v in counts.items():
            self.counts[k] += times * (self.counts[k] - v)
        for k, v in list(self.ops.items()):
            self.ops[k] = v + times * (v - ops.get(k, 0))

    def _collective(self, rule: _Rule, args, out, x: int) -> None:
        if rule.mem == "c10d":
            kind, src, dst = _C10D[rule.name]
            b = _sum_bytes(args[src])
            res = b if dst is None else _sum_bytes(args[dst])
        else:
            kind = _C10D_FUNCTIONAL[rule.name]
            b = _sum_bytes(args[0])
            res = _sum_bytes(out)
        c = self.counts
        c[kind] += x * b
        c["collective_count"] += x
        c["bytes"] += x * (b + res)

    def _price(self, rule: _Rule, args, kwargs, ins: list, outs: list,
               x: int) -> None:
        c = self.counts
        if rule.flops is not None:
            if rule.flops == "matmul":
                base = _base(rule.name)
                f = 2 * outs[0].numel() * _contraction(base, args)
                c["matmul_flops"] += x * f
                if base.startswith("add") or base == "baddbmm":
                    f += outs[0].numel()
                c["flops"] += x * f
            elif rule.flops == "trans":
                n = sum(t.numel() for t in outs)
                c["flops"] += x * n
                c["transcendentals"] += x * n
            elif rule.flops == "trans_in":
                n = ins[0].numel()
                c["flops"] += x * n
                c["transcendentals"] += x * n
            elif rule.flops == "arith":
                c["flops"] += x * sum(t.numel() for t in outs)
            elif ins:
                c["flops"] += x * ins[0].numel()
        if rule.mem == "read_index":
            c["bytes"] += x * 2 * sum(_nbytes(t) for t in outs)
            return
        if rule.mem == "write_index":
            upd = args[rule.update] if len(args) > rule.update \
                else kwargs.get("values")
            c["bytes"] += x * 2 * _sum_bytes(upd)
            return
        read = ins[1:] if rule.mem == "overwrite" else ins
        c["bytes"] += x * (sum(_nbytes(t) for t in outs)
                           + sum(_nbytes(t) for t in read))

    def _times(self) -> int:
        """How many times the running op counts: 1, or in the backward
        pass of a priced loop's step the steps it stands for.  An op under
        a backward node with grad mode on is a checkpoint's recomputation,
        a forward priced as it runs."""
        if not self.loops or torch.is_grad_enabled():
            return 1
        node = torch._C._current_autograd_node()
        return 1 if node is None else self._scale(node._sequence_nr())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if not _is_plain(t):
                return NotImplemented
        if func is _DEVICE and isinstance(args[0], FakeTensor):
            # a device query moves nothing: answered here, as
            # FakeTensorMode answers it outside a kernel (half the ops a
            # traced step dispatches are these)
            return args[0].fake_device
        out = func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = _make_rule(func)
        x = self._times()
        if rule.kind != "none":
            self.ops[rule.name] = self.ops.get(rule.name, 0) + x
        if rule.kind == "collective":
            self._collective(rule, args, out, x)
        elif rule.kind != "none":
            ins = _flat(kwargs, _flat(args, []))
            outs = _flat(out, [])
            if rule.kind == "aten":
                self._price(rule, args, kwargs, ins, outs, x)
            # a new storage is live from here, priced or not
            given = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                if id(t.untyped_storage()) not in given:
                    self.track(t)
        return out

    # ------------------------------------------------------------------
    def result(self) -> dict[str, Any]:
        c = self.counts
        return {
            "flops": float(c["flops"]),
            "matmul_flops": float(c["matmul_flops"]),
            "transcendentals": float(c["transcendentals"]),
            "bytes": float(c["bytes"]),
            "collective_bytes": float(sum(c[k] for k in COLLECTIVE_KINDS)),
            "collectives_by_kind": {k: float(c[k])
                                    for k in COLLECTIVE_KINDS},
            "collective_count": c["collective_count"],
        }


def pad_steps(results: list, n: int) -> None:
    """Pad the step results of a :func:`steps` loop that ran fewer than
    ``n`` steps (a priced loop) to ``n`` entries, with the last one
    detached: the padding takes no gradient, so the backward pass through
    the loop is the one of the steps that ran.  Nothing for a loop that
    ran whole."""
    if len(results) < n:
        results += [results[-1].detach()] * (n - len(results))


def steps(n: int) -> Iterator[int]:
    """``range(n)``, for a loop whose steps run the same ops on the same
    shapes.  Under an :class:`OpCost` that prices loops (the dry-run's,
    on fake tensors) only steps 0 to 3 run, and step 2 stands for steps 2
    to n - 2: what it costs is counted ``n - 4`` more times as it runs,
    its autograd nodes' backward ``n - 3`` times, and what it leaves
    alive past step 3 (saved for the backward pass, appended to a list)
    ``n - 4`` more times, until freed: ``hlo_cost``'s rule for a while
    loop, its body times its trips.  A middle step, so that a gradient
    summed over the steps (a weight's, the carry's) is summed as often as
    in the whole loop.  A loop that appends each step's result to a list
    pads the list to ``n`` after it (:func:`pad_steps`)."""
    mode = _PRICING[-1] if _PRICING else None
    if mode is None or n <= 4:
        yield from range(n)
        return
    yield 0
    yield 1
    before = set(mode._live)
    snap, node = mode.snapshot(), _NEXT_NODE()
    yield 2
    mode._add_since(snap, n - 4)
    mode._scale.scale(node, _NEXT_NODE(), n - 3)
    made = [k for k in mode._live if k not in before]
    outer, mode.since = mode.since, mode.live
    try:
        yield 3
    finally:
        # also where the loop is left in step 3: a checkpoint's
        # recomputation stops once it has made the last tensor it needs
        step_peak = mode.since
        # what step 2 made and step 3 did not free is kept by every step
        mode._stand_for([k for k in made if k in mode._live], n - 4,
                        step_peak)
        mode.since = max(outer, step_peak, mode.live)


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses, a
    DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    out = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def _storage_bytes(tensors: list[torch.Tensor]) -> tuple[int, set[int]]:
    keys: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        keys.setdefault(id(st), st.nbytes())
    return sum(keys.values()), set(keys)


def analyze_step(fn: Callable, *args, loops: bool = False, **kwargs
                 ) -> dict[str, Any]:
    """``fn(*args, **kwargs)`` under :class:`OpCost`: ``hlo_cost.analyze``'s
    keys (``flops``, ``transcendentals``, ``bytes``, ``collective_bytes``,
    ``collectives_by_kind``, ``collective_count``), ``matmul_flops``, the
    memory fields (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``alias_size_in_bytes``, ``temp_size_in_bytes``, ``peak_bytes``) and
    ``ops`` (calls by op name).  ``fn``'s result is not returned: it is
    freed after it is measured.  ``loops=True`` prices the :func:`steps`
    loops by trips (fake tensors only)."""
    mode = OpCost(loops=loops)
    arg_tensors = _leaves((args, kwargs))
    arg_bytes, arg_keys = _storage_bytes(arg_tensors)
    for t in arg_tensors:
        mode.track(t)
    del arg_tensors
    # storages are freed as their last reference goes, never by a cycle
    # collection that runs at a moment the step does not set
    gc.collect()
    gc.disable()
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        gc.enable()
    out_tensors = _leaves(out)
    out_bytes, out_keys = _storage_bytes(out_tensors)
    alias = 0
    seen: set[int] = set()
    for t in out_tensors:
        st = t.untyped_storage()
        if id(st) in arg_keys and id(st) not in seen:
            seen.add(id(st))
            alias += st.nbytes()
    del out, out_tensors
    res = mode.result()
    res.update(argument_size_in_bytes=arg_bytes,
               output_size_in_bytes=out_bytes,
               alias_size_in_bytes=alias,
               temp_size_in_bytes=mode.peak - arg_bytes,
               peak_bytes=mode.peak,
               ops=dict(sorted(mode.ops.items())))
    return res
