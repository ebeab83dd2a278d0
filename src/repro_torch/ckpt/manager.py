"""Checkpointing: atomic, async, retention-managed.  The port's
counterpart of ``repro.ckpt.manager``, with the same files.

Format: one ``.npz`` per process holding this process's data (key = the
flattened tree path: dict keys, and ``.<field>`` for a dataclass field,
joined by ``/``) plus a JSON manifest with the step and every leaf's shape
and dtype.  numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf
is stored as its ``uint16`` bits and the manifest records ``"bfloat16"``;
restore views the bits back.  Restore puts each leaf on the device and
in the dtype of the ``like`` tree it is given.

Write protocol (crash-safe): write to ``step_<n>.tmp/``, then rename it
atomically to ``step_<n>/``, so a partly written checkpoint is never
visible to ``latest_step``.  Async mode copies the tensors to host memory
on the caller's thread and writes the files on a background thread, so
training goes on during the write (and may update the tensors in place).

A state on a mesh (DTensor leaves) is saved whole: every rank gathers
each leaf in turn, one leaf at a time, and rank 0 alone writes
``proc_0.npz``.  Restoring with ``shardings`` (or into a ``like`` tree of
DTensors) reads those whole leaves and keeps each rank's shard under the
caller's placements, whatever mesh saved them: the reference's elastic
re-shard.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import process_rank
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import NamedSharding

PyTree = Any
_SEP = "/"


def _leaves_with_keys(tree: PyTree, path: tuple[str, ...] = ()):
    """(key, leaf) of every tensor leaf; None stands for no leaf."""
    if tree is None:
        return
    if isinstance(tree, NamedSharding):
        yield _SEP.join(path), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, (*path, str(k)))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_keys(getattr(tree, f.name),
                                         (*path, f".{f.name}"))
    else:
        yield _SEP.join(path), tree


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a DTensor's whole tensor, gathered) as numpy,
    and the dtype name to record."""
    t = torch.as_tensor(collectives.full_tensor(t)).detach().to(
        "cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _flatten(tree: PyTree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _leaves_with_keys(tree):     # one whole leaf at a time
        flat[key], dtypes[key] = _to_numpy(leaf)
    return flat, dtypes


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def _rebuild(like: PyTree, path: tuple[str, ...], get: Callable) -> PyTree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, (*path, str(k)), get) for k, v in
                like.items()}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), (*path, f".{f.name}"),
                             get)
            for f in dataclasses.fields(like)})
    return get(_SEP.join(path), like)


def save_tree(path: str, tree: PyTree) -> None:
    np.savez(path, **_flatten(tree)[0])


def restore_tree(path: str, like: PyTree,
                 put: Callable[[np.ndarray, str], Any] | None = None
                 ) -> PyTree:
    """Rebuild a ``like``-structured tree from ``path``: each leaf in the
    dtype and on the device of ``like``'s, or ``put(array, key)``."""
    with np.load(path) as data:
        def get(key, leaf):
            arr = data[key]
            return put(arr, key) if put else _from_numpy(arr, leaf)

        return _rebuild(like, (), get)


class CheckpointManager:
    """Directory layout::

        <root>/step_<n>/proc_<i>.npz
        <root>/step_<n>/manifest.json
    """

    def __init__(self, root: str, *, keep_n: int = 3):
        self.root = root
        self.keep_n = keep_n
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._pi = process_rank()[0]

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.root, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def _dir(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.root,
                            f"step_{step}" + (".tmp" if tmp else ""))

    # ------------------------------------------------------------------
    def save(self, state: PyTree, step: int, *, blocking: bool = True
             ) -> None:
        """Copy to host, then write (optionally on a background thread)."""
        self.wait()                      # one in-flight async save at a time
        flat, dtypes = _flatten(state)   # the host copy, on this thread
        shapes = {k: [list(v.shape), dtypes[k]] for k, v in flat.items()}
        if _sharded(state) and self._pi != 0:
            return                       # rank 0 writes the whole leaves

        def write():
            tmp = self._dir(step, tmp=True)
            final = self._dir(step)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"proc_{self._pi}.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "shapes": shapes}, f)
            if os.path.isdir(final):      # re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.root)
            if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, like: PyTree, *, step: int | None = None,
                shardings: PyTree | None = None) -> tuple[PyTree, int]:
        """The checkpoint at ``step`` (None: the latest) in ``like``'s
        structure, dtypes and devices.  ``shardings`` (a tree of
        :class:`NamedSharding` matching ``like``), or DTensor leaves in
        ``like``, place each leaf on the mesh under those placements,
        whatever mesh saved it; a scalar (the step) is restored whole."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        if shardings is None and not _sharded(like):
            path = os.path.join(self._dir(step), f"proc_{self._pi}.npz")
            return restore_tree(path, like), step
        by_key = dict(_leaves_with_keys(shardings)) if shardings else {}
        like_by_key = dict(_leaves_with_keys(like))

        def put(arr, key):
            leaf = like_by_key[key]
            dense = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            full = _from_numpy(arr, dense)
            where = by_key.get(key, leaf)
            if full.dim() == 0 or not isinstance(
                    where, (NamedSharding, DTensor)):
                return full
            return collectives.place(full, where)

        path = os.path.join(self._dir(step), "proc_0.npz")
        return restore_tree(path, like, put=put), step


def _sharded(tree: PyTree) -> bool:
    return any(isinstance(t, DTensor) for _, t in _leaves_with_keys(tree))
