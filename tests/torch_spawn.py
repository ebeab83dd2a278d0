"""Test helper: run a function on every rank of a gloo process group,
one spawned process a rank, on the CPU.

The group meets through a ``FileStore`` under the test's ``tmp_path``
(no TCP port, so parallel test workers never collide), each rank runs
one thread, and the whole group is joined with a timeout: a hang fails
the test instead of eating the suite's time.  ``fn(rank, world, *args)``
must be importable (a module-level function); what it returns is saved
with ``torch.save`` and handed back, one entry a rank.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120.0


def _entry(rank: int, world: int, store: str, fn, args, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args,
              timeout: float = JOIN_TIMEOUT) -> list:
    out_dir = os.path.join(str(tmp_path), f"ranks{time.monotonic_ns()}")
    os.makedirs(out_dir)
    ctx = mp.start_processes(
        _entry, args=(world, os.path.join(out_dir, "store"), fn, args,
                      out_dir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                               f"finish in {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
