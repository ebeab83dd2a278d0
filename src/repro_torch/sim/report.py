"""Simulated-vs-analytic reporting for lowered schedules.

Two consumers: tooling (``compare_plan`` gives JSON rows; the serve
CLI's ``--trace`` writes ``to_chrome_trace``) and humans (``timeline``
renders the first steps of a replay as an event table).
"""
from __future__ import annotations

from typing import Sequence

from .des import ChainSimResult, port_key, simulate, simulate_chain
from .schedule import Comm, Compute, DmaIn, Schedule, lower_chain


def compare_plan(chain) -> dict:
    """Lower + replay a :class:`~repro_torch.core.ftl.partition.ChainPlan`
    (or a ``BlockPlan`` via its ``.chain``) and compare against the
    analytic model.  Returns a JSON-ready dict."""
    chain = getattr(chain, "chain", chain)
    lowered = lower_chain(chain)
    sim = simulate_chain(lowered)
    return {
        "target": chain.target.name,
        "schedule": chain.schedule,
        "analytic_runtime_ms": 1e3 * chain.modeled_runtime_s,
        "sim_runtime_ms": 1e3 * sim.runtime_s,
        "sim_over_analytic": sim.sim_over_analytic,
        "overlap_efficiency": sim.overlap_efficiency,
        "busy_ms": {r: 1e3 * b for r, b in sim.busy_s.items()},
        "segments": [
            {
                "name": s.name,
                "repeat": rep,
                "n_steps": s.n_steps,
                "n_events": len(s.events),
                "analytic_runtime_ms": 1e3 * s.modeled_runtime_s,
                "sim_runtime_ms": 1e3 * r.runtime_s,
                "sim_over_analytic": r.sim_over_analytic,
                "overlap_efficiency": r.overlap_efficiency,
                "stall_ms": {k: 1e3 * v for k, v in r.stall_s.items()},
            }
            for (s, rep), (r, _) in zip(lowered, sim.segments)
        ],
    }


def sim_rows(chains: Sequence) -> list[dict]:
    """``compare_plan`` over several chains (one row each)."""
    return [compare_plan(c) for c in chains]


def _fmt_t(t: float) -> str:
    if t >= 1e-3:
        return f"{1e3 * t:8.3f}ms"
    return f"{1e6 * t:8.2f}us"


def timeline(schedule: Schedule, *, max_steps: int = 4) -> str:
    """Render the replayed event timeline of the first ``max_steps``
    tile steps (plus the schedule's tail) as an aligned text table."""
    res = simulate(schedule, trace=True)
    lines = [
        f"schedule '{schedule.name}' on {schedule.target.name}: "
        f"{schedule.n_steps} steps, depth {schedule.buffer_depth}, "
        f"{len(schedule.events)} events",
        f"simulated {_fmt_t(res.runtime_s).strip()} vs analytic "
        f"{_fmt_t(res.analytic_runtime_s).strip()} "
        f"(x{res.sim_over_analytic:.3f}, overlap eff "
        f"{res.overlap_efficiency:.2f})",
        f"{'start':>10} {'finish':>10}  {'step':>4}  event",
    ]
    tail = 0
    for ev, start, finish in res.trace:
        if ev.step >= max_steps and ev.step < schedule.n_steps - 1:
            tail += 1
            continue
        if tail:
            lines.append(f"{'...':>10} {'':>10}  {tail} events elided")
            tail = 0
        if isinstance(ev, DmaIn):
            desc = (f"DmaIn   {ev.tensor} <- {ev.level} "
                    f"({ev.bytes} B, fetch {ev.fetch}, slot {ev.slot})")
        elif isinstance(ev, Compute):
            desc = f"Compute [{ev.engine}] {'+'.join(ev.ops)}"
        elif isinstance(ev, Comm):
            arrow = "<-" if ev.pre else "->"
            desc = (f"Comm    {ev.op} {arrow} {ev.level} "
                    f"({ev.comm}, {ev.bytes} B)")
        else:
            desc = (f"DmaOut  {ev.tensor} -> {ev.level} "
                    f"({ev.bytes} B, block {ev.block}, slot {ev.slot})")
        lines.append(f"{_fmt_t(start)} {_fmt_t(finish)}  {ev.step:>4}  "
                     f"{desc}")
    return "\n".join(lines)


def chain_timeline(chain, *, max_steps: int = 4) -> str:
    """``timeline`` for every segment of a chain plan."""
    chain = getattr(chain, "chain", chain)
    parts = []
    for sched, rep in lower_chain(chain):
        head = f"[x{rep}] " if rep > 1 else ""
        parts.append(head + timeline(sched, max_steps=max_steps))
    return "\n\n".join(parts)


def to_chrome_trace(chain, *, measured=None, pid: int = 0) -> dict:
    """Replay a chain (or ``BlockPlan``, or a single :class:`Schedule`)
    and export the event timeline as Chrome-tracing JSON — loadable in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

    One track (tid) per resource: ``dma`` (plus ``dma:<port>`` for
    interconnect-port collective streams) and one per engine.  Segments
    are laid out sequentially (each repeated segment is traced once; its
    remaining repeats are summarized by a counter in the event args).
    Timestamps/durations are microseconds, the format's native unit.

    ``measured`` adds a second **measured** track for calibration
    eyeballing: each entry — a ``repro_torch.calib.Measurement`` or a plain
    ``(name, seconds)`` pair — is rendered as one span, laid out
    sequentially from t=0 alongside the simulated tracks, so the
    modeled-vs-measured residual is literally the length mismatch
    between the tracks in Perfetto.

    ``pid`` sets the Chrome-tracing process id of every emitted event,
    so callers merging this timeline with other event sources
    (``repro_torch.obs.export.merged_chrome_trace`` puts live runtime spans on
    their own pid) get disjoint track namespaces.
    """
    if isinstance(chain, Schedule):
        lowered: tuple = ((chain, 1),)
        name = chain.name
        target = chain.target
    else:
        chain = getattr(chain, "chain", chain)
        lowered = lower_chain(chain)
        name = chain.graph.name
        target = chain.target

    tids: dict[str, int] = {"dma": 0}
    events: list[dict] = []
    t0 = 0.0
    for sched, rep in lowered:
        res = simulate(sched, trace=True)
        ports = {lv.name: lv.dma_port for lv in sched.target.backing}
        for ev, start, finish in res.trace:
            if isinstance(ev, DmaIn):
                track, nm = "dma", f"in:{ev.tensor}"
                args = {"step": ev.step, "bytes": ev.bytes,
                        "fetch": ev.fetch, "slot": ev.slot,
                        "level": ev.level}
            elif isinstance(ev, Compute):
                track, nm = f"engine:{ev.engine}", "+".join(ev.ops)
                args = {"step": ev.step}
            elif isinstance(ev, Comm):
                track = port_key(ports[ev.level])
                nm = f"{ev.comm}:{ev.op}"
                args = {"step": ev.step, "bytes": ev.bytes,
                        "level": ev.level, "pre": ev.pre}
            else:
                track, nm = "dma", f"out:{ev.tensor}"
                args = {"step": ev.step, "bytes": ev.bytes,
                        "block": ev.block, "slot": ev.slot,
                        "level": ev.level}
            tid = tids.setdefault(track, len(tids))
            args["segment"] = sched.name
            if rep > 1:
                args["repeat"] = rep
            events.append({
                "name": nm, "ph": "X", "pid": pid, "tid": tid,
                "ts": 1e6 * (t0 + start),
                "dur": 1e6 * (finish - start),
                "cat": track.split(":")[0],
                "args": args,
            })
        t0 += res.runtime_s * rep
    if measured:
        tid = tids.setdefault("measured", len(tids))
        tm = 0.0
        for entry in measured:
            if hasattr(entry, "measured_s"):     # calib.Measurement
                nm, secs = entry.name, float(entry.measured_s)
                args = {"kind": getattr(entry, "kind", "measured")}
            else:
                nm, secs = entry[0], float(entry[1])
                args = {}
            events.append({
                "name": nm, "ph": "X", "pid": pid, "tid": tid,
                "ts": 1e6 * tm, "dur": 1e6 * secs,
                "cat": "measured",
                "args": {**args, "measured_ms": 1e3 * secs,
                         "modeled_ms": 1e3 * t0},
            })
            tm += secs
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"{name} on {target.name}"}},
    ] + [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": track}}
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(chain, path, *, measured=None) -> None:
    """``to_chrome_trace`` serialized to ``path``."""
    import json

    with open(path, "w") as f:
        json.dump(to_chrome_trace(chain, measured=measured), f)


__all__ = ["compare_plan", "sim_rows", "timeline", "chain_timeline",
           "to_chrome_trace", "write_chrome_trace", "ChainSimResult"]
