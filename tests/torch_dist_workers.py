"""Test helper: the per-rank bodies the multi-rank parity tests spawn
(``torch_spawn.run_ranks``).  They import only torch and ``repro_torch``,
so that each spawned rank starts quickly; the reference's side runs in
the test's own process.  Each returns plain tensors and numbers."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cfg(arch: str, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _state_on(mesh, cfg, weights: dict, compress: bool):
    """The reference's weights placed on ``mesh``: the state a mesh
    trainer holds, moments and error zero."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.train import steps as S

    params = params_from_numpy(weights, "cpu")
    params = C.place_tree(params, param_shardings(params, mesh, cfg))
    opt = {"m": C.map_with_path(lambda _, t: S._zeros_f32(t), params),
           "v": C.map_with_path(lambda _, t: S._zeros_f32(t), params)}
    ef = C.map_with_path(lambda _, t: S._zeros_f32(t), params) if compress else None
    return S.TrainState(params, opt, torch.zeros((), dtype=torch.int32), ef)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else
            v.detach().float().numpy() for k, v in tree.items()}


def train_steps(rank, world, runs, weights, batches, opt_kw,
                arch="llama3.2-3b", kw=None):
    """For each (mesh shape, accum, compress) in ``runs``: steps of
    reduced ``arch`` (llama3.2-3b; config fields ``kw``) from
    ``weights`` on that mesh, each on this rank's rows of
    ``batches[i]``.  Returns {run: (metrics a step, whole params after
    the last, the error state's sum of squares with ``compress``)}."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    # remat on: the recomputation in the backward gathers again
    cfg = _cfg(arch, **{"remat": True, **(kw or {})})
    out = {}
    for shape, accum, compress in runs:
        mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):],
                         device="cpu")
        state = _state_on(mesh, cfg, weights, compress)
        step = S.make_train_step(cfg, mesh, OptConfig(**opt_kw),
                                 accum=accum, compress=compress)
        log = []
        for b in batches:
            state, m = step(state, S.shard_batch(
                {"tokens": torch.from_numpy(b)}, mesh))
            log.append({k: float(v) for k, v in m.items()})
        out[(shape, accum, compress)] = (
            log, _tree_np(C.gather_tree(state.params)),
            None if not compress else float(sum(
                torch.sum(t.float() ** 2) for t in
                C.paths_and_leaves(C.gather_tree(state.ef_error)).values())))
    return out


def moe_loss(rank, world, runs: dict, shape=None, arch="qwen2-moe-a2.7b"):
    """For each ``name: (weights, tokens, kw)`` in ``runs``: reduced
    ``arch`` (qwen2-moe-a2.7b; config fields ``kw``) on a ``shape``
    (default world x 1) ``data x model`` mesh, the loss, its aux and the
    whole gradient of one step's dp mean, from the step's metrics and
    its first AdamW moment (lr 0: the weights stay).  ``tokens`` may be
    a whole batch, a dict with the frames or image embeddings beside
    them."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    mesh = make_mesh(shape or (world, 1), ("data", "model"), device="cpu")
    out = {}
    for name, (weights, tokens, kw) in runs.items():
        cfg = _cfg(arch, **kw)
        state = _state_on(mesh, cfg, weights, False)
        step = S.make_train_step(cfg, mesh, OptConfig(peak_lr=0.0,
                                                      warmup_steps=0))
        batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        state, m = step(state, S.shard_batch(
            {k: torch.from_numpy(v) for k, v in batch.items()}, mesh))
        # m = (1 - b1) * clip * g at step 0: the clipped mean gradient
        out[name] = ({k: float(v) for k, v in m.items()},
                     _tree_np(C.gather_tree(state.opt["m"])))
    return out


def serve_steps(rank, world, arch, shape, weights, tokens, n_prompt,
                max_seq, lag=None, kw=None, local_shapes=False):
    """Prefill ``n_prompt`` tokens and decode the rest of ``tokens`` one
    at a time through the mesh serving steps, on this rank's rows;
    ``lag`` (one int a row of the global batch) decodes each row at its
    own position, ``lag`` behind the step's (a per-row ``pos``).
    ``tokens`` may be a dict that holds the prefill's frames or image
    embeddings beside them.  Returns (this rank's dp coordinate, prefill
    logits, each decode step's logits, the cache's placements), and with
    ``local_shapes`` the shape of each cache leaf's local shard after the
    last step."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import steps as S

    cfg = _cfg(arch, **(kw or {}))
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    params = params_from_numpy(weights, "cpu")
    params = C.place_tree(params, param_shardings(params, mesh, cfg))
    prefill = S.make_prefill_step(cfg, mesh, max_seq=max_seq)
    decode = S.make_decode_step(cfg, mesh)
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    rows = S.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                         mesh)
    toks = rows.pop("tokens")
    if lag is not None:
        lag = C.dp_rows(torch.as_tensor(lag), mesh)
    logits, cache = prefill(params, {"tokens": toks[:, :n_prompt], **rows})
    steps = []
    for i in range(n_prompt, toks.shape[1]):
        pos = torch.tensor(i) if lag is None else i - lag
        lg, cache = decode(params, cache, toks[:, i:i + 1], pos)
        steps.append(lg.numpy())
    leaves = C.paths_and_leaves(cache)
    specs = {"/".join(p): tuple(map(str, t.placements))
             for p, t in leaves.items()}
    out = (C.dp_rank(mesh), logits.numpy(), steps, specs)
    if local_shapes:
        out += ({"/".join(p): tuple(t.to_local().shape)
                 for p, t in leaves.items()},)
    return out


def train_cli(rank, world, root: str, argv: list[str]):
    """The train CLI's ``build`` and ``run`` with ``--mesh``: once
    unbroken to 4 steps, once to 2 and resumed from its checkpoint to 4.
    Returns both runs' whole final params."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import train

    out = []
    for name, steps in (("unbroken", [4]), ("resumed", [2, 4])):
        for n in steps:
            args = train.parser().parse_args(
                [*argv, "--steps", str(n), "--ckpt-dir", f"{root}/{name}"])
            loop = train.build(args)
            loop.run()
        out.append((_tree_np(C.gather_tree(loop.state.params)),
                    loop.metrics_log[-1]["step"], len(loop.metrics_log)))
    return out


def compressed_psum_tree(rank, world, grads, errors):
    """``compressed_psum_tree`` over the default group, on this rank's
    ``grads[rank]`` and ``errors[rank]``."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import compression

    g, e = compression.compressed_psum_tree(
        params_from_numpy(grads[rank], "cpu"), None,
        params_from_numpy(errors[rank], "cpu"))
    return _tree_np(g), _tree_np(e)


def pipeline(rank, world, ws: np.ndarray, x: np.ndarray):
    """``pipeline_forward`` of ``tanh(a @ w)`` layers over a ``pipe``
    mesh of every rank: the stages from ``stage_params``, whole on every
    rank, and as a DTensor sharded on the stage dim over ``pipe`` (each
    rank holding its own stage)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import (pipeline_forward,
                                                  stage_params)
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("pipe",), device="cpu")
    staged = stage_params([{"w": torch.from_numpy(w)} for w in ws], world)
    sharded = {"w": C.place(staged["w"], NamedSharding(mesh, P("pipe")))}

    def stage_fn(p, a):
        for w in p["w"]:
            a = torch.tanh(a @ w)
        return a

    return [pipeline_forward(stage_fn, st, torch.from_numpy(x),
                             mesh=mesh).numpy() for st in (staged, sharded)]


def sharded_init(rank, world, archs, batches):
    """``init_train_state`` of each reduced config on a 2x2 mesh: the
    whole params gathered, this rank's shard shapes, and the metrics of
    one compressed mesh step on this rank's rows of ``batches[arch]``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    try:                    # 3 rows do not split over 2 dp ranks
        S.shard_batch({"tokens": torch.zeros((3, 4))}, mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    for arch in archs:
        cfg = _cfg(arch)
        state = S.init_train_state(cfg, 7, device="cpu", mesh=mesh,
                                   compress=True)
        whole = _tree_np(C.gather_tree(state.params))
        step = S.make_train_step(cfg, mesh, OptConfig(), compress=True)
        _, m = step(state, S.shard_batch(
            {k: torch.from_numpy(v) for k, v in batches[arch].items()},
            mesh))
        out[arch] = (whole,
                     {"/".join(p): tuple(t.to_local().shape) for p, t in
                      C.paths_and_leaves(state.params).items()},
                     {"/".join(p): tuple(t.to_local().shape) for p, t in
                      C.paths_and_leaves(state.ef_error).items()},
                     {k: float(v) for k, v in m.items()})
    return out


def two_by_two(rank, world, serve: dict, init_archs, init_batches,
               cli_root: str, cli_argv: list[str]):
    """Everything the 2x2 tests hold, in one group: :func:`serve_steps`
    for each ``arch: (weights, tokens, n_prompt, max_seq)`` in ``serve``,
    :func:`sharded_init`, then :func:`train_cli`."""
    return {"serve": {arch: serve_steps(rank, world, arch, (2, 2), *a)
                      for arch, a in serve.items()},
            "init": sharded_init(rank, world, init_archs, init_batches),
            "cli": train_cli(rank, world, cli_root, cli_argv)}


def _model_gathers():
    """Record every gather over a ``model`` dim of size > 1 that
    ``collectives.gather_full`` makes: a weight's, inside
    ``ParamGather.__call__``, and any other (a cache leaf's, a tree's
    gathered for a comparison) outside it.  Returns the two lists it
    appends the gathered shards' shapes to."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import collectives as C

    seen: list = []
    outside: list = []
    inside = [0]
    plain, call = C.gather_full, C.ParamGather.__call__

    def spy(x, placements, mesh, only=None):
        for i, (name, n) in enumerate(zip(mesh.mesh_dim_names, mesh.shape)):
            if name == "model" and n > 1 \
                    and isinstance(placements[i], Shard) \
                    and (only is None or i in only):
                (seen if inside[0] else outside).append(tuple(x.shape))
        return plain(x, placements, mesh, only)

    def gatherer(self, *args, **kw):
        inside[0] += 1
        try:
            return call(self, *args, **kw)
        finally:
            inside[0] -= 1

    C.gather_full, C.ParamGather.__call__ = spy, gatherer
    return seen, outside


def tp_cases(rank, world, train: dict, grads: dict, serve: dict):
    """The tensor-parallel cases of ``tests/test_torch_tp.py`` in one
    group: for each ``name: (arch, kw, shape, weights, batches, opt_kw)``
    in ``train`` the :func:`train_steps` of one run; for each ``name:
    (arch, shape, runs)`` in ``grads`` :func:`moe_loss`; for each ``name:
    (arch,
    kw, shape, weights, tokens, n_prompt, max_seq, lag)`` in ``serve``
    :func:`serve_steps` with the local shapes of the cache's shards.
    Beside each, the shapes of the weights the steps gathered over
    ``model``; beside a serving case, also those of any other tensor
    gathered over it whole (none: no cache leaf is)."""
    seen, outside = _model_gathers()
    out: dict = {"train": {}, "grads": {}, "serve": {}}
    for name, (arch, kw, shape, weights, batches, opt_kw) in train.items():
        del seen[:]
        res = train_steps(rank, world, [(shape, 1, False)], weights,
                          batches, opt_kw, arch=arch, kw=kw)
        out["train"][name] = (res[(shape, 1, False)], list(seen))
    for name, (arch, shape, runs) in grads.items():
        del seen[:]
        out["grads"][name] = (moe_loss(rank, world, runs, shape, arch),
                              list(seen))
    for name, (arch, kw, shape, weights, tokens, n, max_seq, lag) in \
            serve.items():
        del seen[:], outside[:]
        out["serve"][name] = (serve_steps(rank, world, arch, shape, weights,
                                          tokens, n, max_seq, lag, kw,
                                          local_shapes=True),
                              list(seen), list(outside))
    return out
