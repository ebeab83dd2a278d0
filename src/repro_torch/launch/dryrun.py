"""Multi-pod dry-run of the port: the counterpart of
``repro.launch.dryrun``.

For every (architecture × input-shape) cell, on the single-pod 16×16 mesh
and the dual-pod 2×16×16 mesh:

  1. set up a fake process group of the mesh's size (rank 0; its
     collectives return at once) and the production ``DeviceMesh`` over
     it,
  2. build the state and the batch from shapes only
     (``train_state_shapes``, ``param_shapes``, ``make_batch_shapes``,
     the cache on ``meta``), each leaf rank 0's shard under
     ``FakeTensorMode``, placed by ``train_step_shardings``,
     ``param_pspecs``/``batch_pspecs`` or ``decode_shardings``,
  3. run rank 0's train, prefill or decode step on those fake CPU
     tensors under :mod:`repro_torch.roofline.op_cost`: per-chip FLOPs,
     bytes, collective bytes by kind, and live memory,
  4. build the three-term roofline from ``model_flops`` and
     ``HW.from_target`` of the planning target (``FTL_TARGET``, detection,
     or ``--target``).

A fake tensor lies on the CPU, so every kernel wrapper takes its plain
PyTorch version: the dry-run prices the port's plain path, as the
reference's prices its XLA path (on CPU devices its ops resolve to
``ref`` and a Pallas custom call costs nothing).  It launches no kernel.
The port's mesh steps split the work over ``model`` as the reference's
rules lay it out, the recurrent mixers' too; the mLSTM's sequence scan
runs whole on every rank, on q, k and v gathered over ``model``, as the
reference's own Pallas call runs on gathered operands.

The records keep the reference's keys where a counterpart exists.
``lower_s`` is the trace's seconds.  ``compile_s``, ``xla_flops_raw``,
``xla_bytes_raw`` and ``generated_code_size_in_bytes`` have none (there
is no compiler) and are left out; ``matmul_flops_per_chip`` and
``peak_bytes`` (arguments plus temporaries) are added.  A cell that
fails is recorded with its traceback, not hidden, and the CLI exits 1.

Artifacts: results/dryrun_torch/<arch>__<shape>__<mesh>.json

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.configs import SHAPES, get_config, get_shape
from repro_torch.core import hw as hw_targets
from repro_torch.data.pipeline import make_batch_shapes
from repro_torch.distributed.sharding import (NamedSharding, batch_pspecs,
                                              dp_axes, map_with_path,
                                              mesh_shape, param_pspecs,
                                              to_shardings)
from repro_torch.launch.mesh import production_layout
from repro_torch.models import model as M
from repro_torch.optim import OptConfig
from repro_torch.roofline import model_flops, roofline
from repro_torch.roofline.analysis import HW, CollectiveStats
from repro_torch.roofline.op_cost import analyze_step
from repro_torch.train import steps as S

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "..", "..", "..", "results", "dryrun_torch")


# ---------------------------------------------------------------------------
# cell enumeration (the reference's skip rules)
# ---------------------------------------------------------------------------

def cell_status(arch: str, shape_name: str) -> str:
    """'run' or the documented skip reason."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return "skip: full quadratic attention at 512k (task rule)"
    return "run"


def all_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in configs.ARCHS:
        for shape_name in SHAPES:
            out.append((arch, shape_name, cell_status(arch, shape_name)))
    return out


# ---------------------------------------------------------------------------
# tracing one cell
# ---------------------------------------------------------------------------

def _accum_for(cfg, shape, mesh) -> int:
    """Grad-accum depth: 1 token-microbatch per data shard per step."""
    sizes = mesh_shape(mesh)
    dp = 1
    for a in dp_axes(mesh):
        dp *= sizes[a]
    per_shard = max(1, shape.global_batch // dp)
    micro = 1
    return max(1, per_shard // micro)


def apply_opt_level(cfg, opt: bool):
    """The optimized configuration: blockwise (flash-scheduled) attention
    on the plain path from 8k keys, grouped MoE dispatch, chunked-remat
    mLSTM."""
    if not opt:
        return cfg
    from repro_torch.kernels import ops
    ops.set_plain_attention("blockwise", min_len=8192)
    repl = {}
    if cfg.is_moe:
        repl.update(moe_dispatch="grouped", moe_groups=16)
    if cfg.family == "ssm":
        repl.update(mlstm_chunk=256)
    return dataclasses.replace(cfg, **repl) if repl else cfg


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str = "cpu"):
    """A fake process group of ``prod(shape)`` ranks, this process rank 0,
    and a ``DeviceMesh`` of ``shape`` over it on ``device`` (the CPU, or
    ``"cuda"`` for one rank's compute on the card); the group is
    destroyed on exit.  Only the dry-run and such a one-rank run build a
    mesh over a fake group (``launch.mesh`` refuses one)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run sets up its own fake process "
                           "group, and a process group is up already")
    size = 1
    for n in shape:
        size *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield DeviceMesh(device, torch.arange(size).reshape(shape),
                         mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _shard(full: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """Rank 0's shard of a ``meta`` leaf as a DTensor over a fake local
    tensor (call under ``FakeTensorMode``)."""
    local = torch.empty(sharding.shard_shape(tuple(full.shape)),
                        dtype=full.dtype, device="cpu")
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def _place(tree, shardings):
    return map_with_path(lambda _, t, sh: _shard(t, sh), tree, shardings)


def _local_rows(batch: dict, shardings: dict) -> dict:
    return {k: _shard(v, shardings[k]).to_local() for k, v in batch.items()}


# the counts of a trace that add up op by op
_ADDITIVE = ("flops", "matmul_flops", "transcendentals", "bytes",
             "collective_bytes", "collective_count")


def _loop_priced(c2: dict, c3: dict, trips: int) -> dict:
    """The cost of a step whose gradient-accumulation loop runs ``trips``
    times, from traces of 2 and 3: what is outside the loop plus ``trips``
    times its body, the difference of the two (``hlo_cost``'s rule for a
    while loop).  Every microbatch runs the same ops on the same shapes,
    so this is exact for every count; the live memory of a microbatch is
    the same from the second on, so the peak is the larger trace's."""
    out = dict(c3)

    def at(a, b):
        return a + (trips - 2) * (b - a)

    for k in _ADDITIVE:
        out[k] = at(c2[k], c3[k])
    out["collectives_by_kind"] = {
        k: at(c2["collectives_by_kind"][k], v)
        for k, v in c3["collectives_by_kind"].items()}
    out["ops"] = {k: at(c2["ops"].get(k, 0), v)
                  for k, v in c3["ops"].items()}
    out["temp_size_in_bytes"] = max(c2["temp_size_in_bytes"],
                                    c3["temp_size_in_bytes"])
    out["peak_bytes"] = out["argument_size_in_bytes"] \
        + out["temp_size_in_bytes"]
    return out


def _trace(cfg, shape, mesh, *, unrolled: bool = False) -> dict:
    """Rank 0's step of the cell under ``op_cost``, its time loops
    priced by trips (``op_cost.steps``).  A train step whose accumulation
    loop runs more than 3 microbatches is traced with 2 and with 3 of
    them and priced by :func:`_loop_priced`.  ``unrolled`` runs every
    loop whole instead (the tests hold the two equal)."""
    loops = not unrolled
    from torch._subclasses.fake_tensor import FakeTensorMode

    batch_sds = make_batch_shapes(cfg, shape)
    if shape.kind == "train":
        state_sds = S.train_state_shapes(cfg)
        accum = _accum_for(cfg, shape, mesh)
        (ssh, bsh), _ = S.train_step_shardings(cfg, mesh, state_sds,
                                                batch_sds)
    elif shape.kind == "prefill":
        params_sds = M.param_shapes(cfg)
        step = S.make_prefill_step(cfg, mesh)
        psh = to_shardings(param_pspecs(params_sds, mesh, cfg), mesh)
        bsh = to_shardings(batch_pspecs(batch_sds, mesh), mesh)
    else:  # decode
        params_sds = M.param_shapes(cfg)
        cache_sds = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
        step = S.make_decode_step(cfg, mesh)
        psh, csh, tsh, _ = S.decode_shardings(cfg, mesh, params_sds,
                                              cache_sds, shape.global_batch)
        token_sds = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                device="meta")
    with FakeTensorMode():
        if shape.kind != "train":
            if shape.kind == "prefill":
                args = (_place(params_sds, psh), _local_rows(batch_sds, bsh))
            else:
                args = (_place(params_sds, psh), _place(cache_sds, csh),
                        _shard(token_sds, tsh).to_local(),
                        torch.zeros((), dtype=torch.int32, device="cpu"))
            return analyze_step(step, *args, loops=loops)
        batch = _local_rows(batch_sds, bsh)

        def train(n: int) -> dict:
            # n microbatches of the cell's size: the first rows of its
            # batch (a view: the arguments hold the whole batch)
            rows = next(iter(batch.values())).shape[0] // accum * n
            state = S.TrainState(
                params=_place(state_sds.params, ssh.params),
                opt={k: _place(state_sds.opt[k], ssh.opt[k])
                     for k in ("m", "v")},
                step=torch.zeros((), dtype=torch.int32, device="cpu"))
            step = S.make_train_step(cfg, mesh, OptConfig(), accum=n)
            return analyze_step(step, state,
                                {k: v[:rows] for k, v in batch.items()},
                                loops=loops)

        if unrolled or accum <= 3:
            return train(accum)
        return _loop_priced(train(2), train(3), accum)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               opt: bool = False, cfg=None, shape=None,
               layout: tuple[tuple[int, ...], tuple[str, ...]] | None = None
               ) -> dict:
    """The record of one cell (the reference returns its lowered and
    compiled programs beside it; here there are none).  ``cfg`` replaces
    the arch's config, ``shape`` the cell's ShapeSpec and ``layout`` the
    production mesh's (shape, axes): the CPU tests trace reduced configs
    at small shapes on a 2 x 2 mesh."""
    cfg = apply_opt_level(cfg if cfg is not None else get_config(arch), opt)
    shape = shape if shape is not None else get_shape(shape_name)
    dims, axes = layout or production_layout(multi_pod=multi_pod)
    t0 = time.time()
    with fake_mesh(dims, axes) as mesh:
        hc = _trace(cfg, shape, mesh)
    t_trace = time.time() - t0

    # the roofline machine is the Target the FTL planner priced its plans
    # against (hw.default_target / FTL_TARGET), recorded per cell
    target = hw_targets.default_target()
    hw = HW.from_target(target)
    rep = roofline(arch=arch, shape=shape, mesh_shape=dims,
                   cost={"flops": hc["flops"], "bytes accessed": hc["bytes"]},
                   coll_stats=CollectiveStats.from_cost(hc),
                   model_flops_total=model_flops(cfg, shape), hw=hw)
    mem_rec = {k: int(hc[k]) for k in (
        "temp_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "alias_size_in_bytes")}
    peak = int(hc["peak_bytes"])
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)), "chips": rep.chips,
        "kind": shape.kind,
        "ftl_target": target.name,
        "lower_s": round(t_trace, 1),
        "cost": {"flops_per_chip": hc["flops"],
                 "bytes_per_chip": hc["bytes"],
                 "transcendentals": hc["transcendentals"],
                 "matmul_flops_per_chip": hc["matmul_flops"]},
        "memory": {**mem_rec, "peak_bytes": peak,
                   "fits": peak <= hw.hbm_bytes},
        "collectives": {"total_bytes": int(hc["collective_bytes"]),
                        "count": hc["collective_count"],
                        "by_kind": {k: int(v) for k, v in
                                    hc["collectives_by_kind"].items()}},
        "roofline": rep.row(),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, skip_existing: bool = False,
             opt: bool = False) -> dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir,
                      f"{arch}__{shape_name}__{mesh_tag}.json")
    if skip_existing and os.path.exists(fn):
        with open(fn) as f:
            return json.load(f)
    status = cell_status(arch, shape_name)
    if status != "run":
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": status}
    else:
        try:
            rec = lower_cell(arch, shape_name, multi_pod=multi_pod, opt=opt)
            rec["status"] = "ok"
        except Exception as e:            # noqa: BLE001 — recorded, not hidden
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "status": f"FAIL: {type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="optimized config (blockwise attention, grouped "
                         "MoE, chunked mLSTM)")
    ap.add_argument("--target", default=None,
                    help=f"planning target preset for the plans and the "
                         f"roofline: one of {sorted(hw_targets.PRESETS)} "
                         f"(default: FTL_TARGET, else the detected card)")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.opt and args.out == os.path.abspath(RESULTS_DIR):
        args.out = args.out + "_opt"
    if args.target is not None:
        hw_targets.set_default_target(args.target)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    fails = 0
    if args.all:
        for arch, shape_name, status in all_cells():
            for mp in meshes:
                rec = run_cell(arch, shape_name, multi_pod=mp,
                               out_dir=args.out,
                               skip_existing=args.skip_existing,
                               opt=args.opt)
                line = rec.get("status", "?")
                print(f"[{rec['mesh']:8s}] {arch:24s} {shape_name:12s} "
                      f"{line[:100]}", flush=True)
                fails += line.startswith("FAIL")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for mp in meshes:
            rec = run_cell(args.arch, args.shape, multi_pod=mp,
                           out_dir=args.out,
                           skip_existing=args.skip_existing,
                           opt=args.opt)
            print(json.dumps(rec, indent=1))
            fails += rec.get("status", "").startswith("FAIL")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
