"""Deterministic synthetic LM data pipeline: the port's copy of
``repro.data.pipeline``, numpy and threads as there, so ``batch_at(i)``
gives the reference's bits for every kind.

Design goals that carry over to a real pipeline 1:1:

* **Counter-based determinism** — batch ``i`` is a pure function of
  ``(seed, i)`` via Philox counters, so a restarted/resharded job resumes
  bit-identically at any step without replaying the stream (the property
  the checkpoint/restart tests assert).
* **Host sharding** — each process materializes only its
  ``global_batch / process_count`` slice: on a mesh, the rank's
  coordinate over the dp axes out of their size (ranks along ``model``
  read the same rows); else the rank and world size of
  ``torch.distributed`` when a process group is up, else 0 of 1.
* **Prefetch** — a daemon thread keeps ``prefetch`` batches ahead so host
  data generation overlaps device compute.

Two token distributions:

* ``random``  — uniform tokens (dry-run / shape tests).
* ``bigram``  — x_{t+1} = (a·x_t + b + ε) mod V with ε ∈ [0, noise):
  a learnable structure whose optimal NLL is log(noise), giving
  integration tests a strict convergence target.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import process_rank, torch_dtype
from repro_torch.distributed import collectives

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "bigram"          # random | bigram
    noise: int = 4                # bigram branching factor
    prefetch: int = 2


def _rng(seed: int, step: int, lane: int = 0) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, lane, step]))


def synth_tokens(cfg: DataConfig, step: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of global batch ``step`` — pure function of inputs."""
    n = hi - lo
    v = cfg.vocab_size
    if cfg.kind == "random":
        g = _rng(cfg.seed, step, 1)
        all_rows = g.integers(0, v, size=(cfg.global_batch, cfg.seq_len),
                              dtype=np.int32)
        return all_rows[lo:hi]
    # bigram: per-row generator keyed by (step, row) so any slice is cheap
    a = (cfg.seed * 2 + 1) % v or 1
    b = (cfg.seed * 7 + 3) % v
    out = np.empty((n, cfg.seq_len), np.int32)
    for i, row in enumerate(range(lo, hi)):
        g = _rng(cfg.seed, step, 2 + row)
        x0 = g.integers(0, v)
        eps = g.integers(0, cfg.noise, size=cfg.seq_len).astype(np.int64)
        xs = np.empty(cfg.seq_len, np.int64)
        cur = int(x0)
        for t in range(cfg.seq_len):
            cur = (a * cur + b + int(eps[t])) % v
            xs[t] = cur
        out[i] = xs.astype(np.int32)
    return out


class SyntheticLM:
    """Restartable host-sharded batch iterator.

    ``batch_at(step)`` returns this process's slice as numpy; ``iterate``
    yields prefetched batches starting at ``start_step``.
    """

    def __init__(self, cfg: DataConfig, *,
                 process_index: int | None = None,
                 process_count: int | None = None, mesh=None):
        self.cfg = cfg
        if mesh is not None:
            rank, world = collectives.dp_rank(mesh), collectives.dp_size(mesh)
        else:
            rank, world = process_rank()
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        assert cfg.global_batch % self.pc == 0
        self.per_host = cfg.global_batch // self.pc

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        lo = self.pi * self.per_host
        return {"tokens": synth_tokens(self.cfg, step, lo,
                                       lo + self.per_host)}

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def optimal_nll(self) -> float:
        """Entropy floor of the bigram stream."""
        if self.cfg.kind == "bigram":
            return float(np.log(self.cfg.noise))
        return float(np.log(self.cfg.vocab_size))


def make_batch_shapes(cfg, shape) -> dict[str, Any]:
    """Stand-ins on the ``meta`` device for every model input of a shape
    cell (``shape.global_batch``, ``shape.seq_len``): shapes and dtypes,
    no allocation."""
    b, s = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.empty(
            (b, cfg.n_image_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device="meta")
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.empty(
            (b, cfg.encoder_seq, cfg.d_model), dtype=torch_dtype(cfg.dtype),
            device="meta")
    return batch
