"""Discrete-event replay of a :class:`~repro_torch.sim.schedule.Schedule`.

Resources and hazards:

* **One unit per DMA port** (``MemoryLevel.dma_port``): every
  ``DmaIn``/``DmaOut``/``Comm`` serializes in program order against the
  other transfers on *its level's* port, each priced at that level
  (``bytes/bw + dma_setup``).  All memory tiers share the default
  ``"dma"`` port (Siracusa's single cluster DMA — with one port in
  play this is exactly the old single-cursor replay), while the
  interconnect (ici/noc) runs on its own port, so a collective stream
  overlaps the same segment's memory DMA instead of queueing behind it
  — the max-over-ports analytic model, replayed rather than asserted.
  Busy time is reported as ``'dma'`` for the default port and
  ``'dma:<port>'`` for others; per-level busy time stays separate.
* **One unit per engine**: compute events on the same engine serialize
  (in order); distinct engines overlap.  Within a step the compute
  chain respects op order (the cluster's GeLU waits for the NPU's GEMM
  of the *same* tile), so cross-engine overlap emerges as a software
  pipeline across steps rather than being assumed.
* **Buffer-slot hazards** from ``buffer_depth``: fetch ``k`` of a
  tensor may not start before the last compute consuming fetch
  ``k − depth`` finished (depth 1 ⇒ load/compute serialize; depth ≥ 2 ⇒
  prefetch runs ahead).  Symmetrically, a step may not start while its
  output block's slot still awaits the write-back of block
  ``b − depth``.
* A step's compute waits for every streamed tile it consumes (the
  Pallas/Deeploy contract: all copies for step ``s`` complete before
  the step body runs).

Every event's start time is a ``max`` over its dependencies, so the
event graph is monotone: relaxing any hazard (e.g. a deeper buffer) can
only move times earlier — the property ``tests/test_torch_sim.py`` fuzzes.
The simulated runtime is consequently ≥ the analytic
``max(compute_time, transfer_time)`` (identical total busy time per
resource, plus real serialization) and converges to it once the
pipeline is deep enough to amortize fill/drain.
"""
from __future__ import annotations

import dataclasses

from .schedule import Comm, Compute, DmaIn, Schedule


def port_key(port: str) -> str:
    """Busy-dict key of a DMA port: the default port keeps the legacy
    ``'dma'`` key (every existing report/gate reads it); other ports
    (ici/noc) get ``'dma:<port>'``."""
    return "dma" if port == "dma" else f"dma:{port}"


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Replay outcome of one schedule (one run of one segment)."""

    runtime_s: float
    busy_s: dict[str, float]   # 'dma[:<port>]' + 'engine:<name>' → busy
    per_level_busy_s: dict[str, float]
    analytic_runtime_s: float
    n_events: int
    trace: tuple[tuple[object, float, float], ...] = ()

    @property
    def stall_s(self) -> dict[str, float]:
        """Idle time per resource over the simulated span."""
        return {r: self.runtime_s - b for r, b in self.busy_s.items()}

    @property
    def overlap_efficiency(self) -> float:
        """Busy fraction of the *dominant* resource: 1.0 means the
        bottleneck never idles — the analytic max() was achieved."""
        if self.runtime_s <= 0.0:
            return 1.0
        return max(self.busy_s.values(), default=0.0) / self.runtime_s

    @property
    def sim_over_analytic(self) -> float:
        """Simulated / analytic runtime (≥ 1 up to float rounding)."""
        if self.analytic_runtime_s <= 0.0:
            return 1.0
        return self.runtime_s / self.analytic_runtime_s


@dataclasses.dataclass(frozen=True)
class ChainSimResult:
    """Replay of a whole chain: segments sequential, × multiplicity."""

    segments: tuple[tuple[SimResult, int], ...]   # (result, repeat)

    @property
    def runtime_s(self) -> float:
        return sum(r.runtime_s * rep for r, rep in self.segments)

    @property
    def analytic_runtime_s(self) -> float:
        return sum(r.analytic_runtime_s * rep for r, rep in self.segments)

    @property
    def sim_over_analytic(self) -> float:
        if self.analytic_runtime_s <= 0.0:
            return 1.0
        return self.runtime_s / self.analytic_runtime_s

    @property
    def busy_s(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r, rep in self.segments:
            for k, v in r.busy_s.items():
                out[k] = out.get(k, 0.0) + v * rep
        return out

    @property
    def overlap_efficiency(self) -> float:
        if self.runtime_s <= 0.0:
            return 1.0
        return max(self.busy_s.values(), default=0.0) / self.runtime_s


def simulate(
    schedule: Schedule,
    *,
    buffer_depth: int | None = None,
    share_ports: bool = False,
    trace: bool = False,
) -> SimResult:
    """Replay ``schedule``; ``buffer_depth`` overrides the lowered depth
    (same logical schedule, different slot hazards and prefetch
    distance — the depth-sweep hook).  ``share_ports`` replays the same
    events with every transfer serialized on the single default DMA
    cursor — the pre-multi-port model, the counterfactual baseline the
    mesh bench gates overlap wins against (merging cursors only adds
    constraints, so the shared-port replay is always ≥ the split one).

    The schedule's events are in *logical* step order (loads, computes,
    store-backs of step ``s`` together); the DES derives the DMA issue
    order from the depth: the loads for step ``s + depth − 1`` are
    issued before step ``s``'s write-backs, exactly the classic
    ``load(s+1); compute(s); store(s)`` double-buffer loop shape, so a
    transfer-bound pipeline keeps the DMA port saturated instead of
    queueing every prefetch behind the previous step's compute.
    """
    depth = buffer_depth if buffer_depth is not None \
        else schedule.buffer_depth
    if depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {depth}")

    def _depth(tensor: str) -> int:
        # per-tensor staging depth (max(fast, home) — the lowering's
        # cost.staging_depths map); an explicit override is uniform,
        # replacing every per-tensor depth — the depth-sweep contract.
        if buffer_depth is not None:
            return buffer_depth
        return schedule.tensor_depths.get(tensor, schedule.buffer_depth)

    steps = schedule.n_steps
    levels = {lv.name: lv for lv in schedule.target.backing}

    comp_by: dict[int, list[Compute]] = {}
    outs_by: dict[int, list] = {}
    pcomm_by: dict[int, list[Comm]] = {}
    for ev in schedule.events:
        if isinstance(ev, Compute):
            comp_by.setdefault(ev.step, []).append(ev)
        elif isinstance(ev, Comm):
            if not ev.pre:
                pcomm_by.setdefault(ev.step, []).append(ev)
        elif not isinstance(ev, DmaIn):
            outs_by.setdefault(ev.step, []).append(ev)

    port_free: dict[str, float] = {}    # one cursor per DMA port
    engine_free: dict[str, float] = {}
    busy: dict[str, float] = {"dma": 0.0}
    level_busy: dict[str, float] = {}
    chain_finish = [0.0] * steps        # per-step compute-chain finish
    use_steps: dict[str, list[int]] = {}   # per in-tensor fetch use-steps
    ready_q: list[tuple[int, float]] = []  # (use_step, DmaIn finish) FIFO
    ready_head = 0
    out_finish: dict[str, list[float]] = {}   # DmaOut finishes per tensor
    out_emitted: dict[str, int] = {}
    last_finish = 0.0
    timeline: list[tuple[object, float, float]] = []

    def _note(ev, start, finish):
        nonlocal last_finish
        last_finish = max(last_finish, finish)
        if trace:
            timeline.append((ev, start, finish))

    def _dma(ev) -> tuple[str, float]:
        lv = levels[ev.level]
        if isinstance(ev, Comm):
            dur = ev.bytes / lv.bw_bytes_per_s + ev.setups * lv.dma_setup_s
        else:
            dur = ev.bytes / lv.bw_bytes_per_s + lv.dma_setup_s
        port = "dma" if share_ports else lv.dma_port
        key = port_key(port)
        busy[key] = busy.get(key, 0.0) + dur
        level_busy[ev.level] = level_busy.get(ev.level, 0.0) + dur
        return port, dur

    def _issue_in(ev) -> None:
        port, dur = _dma(ev)
        start = port_free.get(port, 0.0)
        if isinstance(ev, DmaIn):
            us = use_steps.setdefault(ev.tensor, [])
            us.append(ev.step)
            dt = _depth(ev.tensor)
            if ev.fetch >= dt:
                # slot hazard: this fetch overwrites the buffer that held
                # fetch f−depth, last consumed by the step before fetch
                # f−depth+1 arrived — whose chain is already scheduled
                # (fetch f is issued depth−1 steps ahead of its use at
                # most).
                lu = us[ev.fetch - dt + 1] - 1
                if lu >= 0:
                    start = max(start, chain_finish[lu])
        # pre-Comm chunks have no buffer slot: the link stream lands in
        # the operand's staging buffers like any other prefetch
        finish = start + dur
        port_free[port] = finish
        ready_q.append((ev.step, finish))
        _note(ev, start, finish)

    def _run_step(e: int) -> None:
        nonlocal ready_head
        # chain head: every streamed tile this step consumes is resident
        gate = 0.0
        while ready_head < len(ready_q) and ready_q[ready_head][0] <= e:
            gate = max(gate, ready_q[ready_head][1])
            ready_head += 1
        # ...and the output block's slot has drained its write-back
        for t, n in out_emitted.items():
            dt = _depth(t)
            if n >= dt:
                gate = max(gate, out_finish[t][n - dt])
        prev = gate
        comms = pcomm_by.get(e, [])
        ci = 0

        def _comm(c: Comm, at: float) -> float:
            # post-collective chunk: the reduce of this tile's partial
            # drains on the interconnect port, starting once its
            # producer's compute is done
            port, dur = _dma(c)
            start = max(port_free.get(port, 0.0), at)
            finish = start + dur
            port_free[port] = finish
            _note(c, start, finish)
            return finish

        for ev in comp_by.get(e, ()):
            eng = f"engine:{ev.engine}"
            start = max(engine_free.get(eng, 0.0), prev)
            finish = start + ev.seconds
            engine_free[eng] = finish
            busy[eng] = busy.get(eng, 0.0) + ev.seconds
            prev = finish
            _note(ev, start, finish)
            while ci < len(comms) and comms[ci].after_op in ev.ops:
                f = _comm(comms[ci], prev)
                if comms[ci].blocking:
                    # the reduced value feeds a later op in this chain:
                    # fusing across the collective serializes compute
                    # behind the wire for this tile (the pipeline hides
                    # it across steps, not within one)
                    prev = f
                ci += 1
        for c in comms[ci:]:
            # producer not in this step's chain (tail collective): the
            # chunk gates segment completion only, like a write-back
            _comm(c, prev)
        chain_finish[e] = prev
        for ev in outs_by.get(e, ()):
            port, dur = _dma(ev)
            start = max(port_free.get(port, 0.0), prev)
            finish = start + dur
            port_free[port] = finish
            out_finish.setdefault(ev.tensor, []).append(finish)
            out_emitted[ev.tensor] = out_emitted.get(ev.tensor, 0) + 1
            _note(ev, start, finish)

    # A tensor's fetch for step s is issued at step s − (depth − 1):
    # the prefetch distance its staging depth buys (depth 1 ⇒ issue at
    # the consuming step — load/compute serialize).  With uniform depths
    # this is exactly the classic prologue + steady-state issue loop;
    # per-tensor depths interleave deeper tensors' prefetches earlier.
    issue_at: dict[int, list] = {}
    for ev in schedule.events:
        if isinstance(ev, DmaIn):
            u = max(0, ev.step - (_depth(ev.tensor) - 1))
            issue_at.setdefault(u, []).append(ev)
        elif isinstance(ev, Comm) and ev.pre:
            # an inbound collective chunk prefetches like a streamed
            # tile, at the fast level's pipeline distance
            u = max(0, ev.step - (depth - 1))
            issue_at.setdefault(u, []).append(ev)
    for e in range(steps):
        for ev in issue_at.get(e, ()):
            _issue_in(ev)
        _run_step(e)

    return SimResult(
        runtime_s=last_finish,
        busy_s=busy,
        per_level_busy_s=level_busy,
        analytic_runtime_s=schedule.modeled_runtime_s,
        n_events=len(schedule.events),
        trace=tuple(timeline),
    )


def simulate_chain(
    schedules: tuple[tuple[Schedule, int], ...],
    *,
    buffer_depth: int | None = None,
    share_ports: bool = False,
) -> ChainSimResult:
    """Replay a lowered chain (``repro_torch.sim.schedule.lower_chain`` output):
    segments run sequentially, each simulated once and scaled by its
    multiplicity — mirroring the analytic Σ-over-segments model."""
    return ChainSimResult(segments=tuple(
        (simulate(s, buffer_depth=buffer_depth, share_ports=share_ports),
         rep)
        for s, rep in schedules
    ))
