"""Serving driver of the port: continuous batching on planned schedules.

The counterpart of the reference ``repro.launch.serve``:

* **Paged KV cache** — pure-'attn' decoder-only configs back their cache
  with fixed-size pages allocated per slot (:mod:`.kv_cache`); pages are
  allocated as a slot's position grows and freed on eviction, so
  admission control can queue requests under memory pressure.  Hybrid
  configs keep a dense per-slot cache: recurrent state beside ring-buffered
  local-attention KV; pure-SSM (xLSTM) configs a dense per-slot cache of
  fp32 mLSTM and sLSTM state, whose size does not grow with the context.
* **State at the prompt's end** — a prompt is padded on the right up to its
  bucket, and the prefill takes the recurrent state and the local ring at
  the prompt's last real token (``last_pos``), not at the bucket's end.
* **No plannable block** — a pure-SSM stack has no attention and no MLP to
  plan: its plans are None, the CLI says so, and ``execute_block_plan``
  returns None.
* **Mixed sequence lengths** — each slot decodes at its own position
  (vector ``pos`` through ``model.decode_step``), an encoder–decoder's
  too: its rows write, mask and take their sinusoids there.  (The
  reference's engine decodes encoder–decoder slots at one scalar
  position, the largest among the active slots.)
* **Extras** — one dict of extra model inputs shared by every request
  (``frames`` for an encoder–decoder, ``image_embeds`` for the VLM's
  cross-attention), passed to every prefill; their K and V sit in the
  dense cache's ``cross`` leaves, whole, and decode only reads them.
* **Plan cache** — serving plans are keyed ``(cfg, bucketed m, dtype,
  target, phase)``; the bucket ladder and the decode plan are planned
  ahead, so steady state replans exactly zero times.
* **Split prefill/decode plans** — decode plans at ``m=1``; their bindings
  never qualify the kernels (decode-shape qualification).  Under
  ``ftl_mode='fused'`` the MLP is the fused-MLP kernel in both regimes;
  under ``'auto'`` (the CLI's mode for an ungated MLP,
  :func:`serving_ftl_mode`) the plan's binding decides.
* **Telemetry** (``obs=True``, the CLI's ``--obs``) — spans, the
  reference's gauges, counter and decode-step histogram, a collector that
  re-reads ``stats`` and ``plan_report()`` at scrape time, and an online
  drift monitor fed by :meth:`ServeEngine.execute_block_plan` (the whole
  planned block at the serving shape) and by a sampled decode step.  An
  engine without it pays nothing.

On the card (default)::

  python -m repro_torch.launch.serve --arch llama3.2-3b

On the CPU at a reduced size::

  python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
      --device cpu --requests 3 --slots 2 --prompt-len 8 --max-new 6

With telemetry: ``--obs`` prints the drift monitor's summary after the
run, ``--obs-trace PATH`` writes the merged live+modeled Perfetto
timeline, ``--obs-metrics PATH`` the Prometheus text (both imply
``--obs``); ``--trace PATH`` writes the decode plan's simulated timeline
(with ``--obs``: the merged one, after the run).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.core.ftl import executor_block
from repro_torch.core.ftl import registry as ftl_registry
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.launch import kv_cache as KV
from repro_torch.models import model as M
from repro_torch.train import steps as S

# how often an obs-enabled engine samples a decode step into the drift
# monitor (report-only rows; whole-block rows come from
# execute_block_plan)
_DRIFT_SAMPLE_EVERY = 16

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_s: float = 0.0       # open-loop arrival offset from run start
    bucket: int = 0              # prefill bucket the prompt landed in
    t_arrival: float = 0.0       # absolute times (perf_counter)
    t_admitted: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        """Arrival → completion, including queueing for a slot."""
        return self.t_done - self.t_arrival

    @property
    def ttft_s(self) -> float:
        """Arrival → first token (the prefill's token)."""
        return self.t_admitted - self.t_arrival


class PlanCache:
    """Serving plan cache keyed ``(cfg, bucketed m, dtype, target,
    phase)``: a counting wrapper over :func:`repro_torch.models.model.
    serve_plan`.  ``warmup`` plans the whole bucket ladder plus the decode
    plan, after which every lookup must hit — ``misses_after_warmup`` is
    the "zero replans in steady state" counter."""

    def __init__(self, cfg, *, dtype: str, target: hw.Target,
                 buckets: tuple[int, ...], device: torch.device):
        self.cfg = cfg
        self.dtype = dtype
        self.target = target
        self.buckets = tuple(buckets)
        self.device = device
        self._plans: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self.warmed = False
        self.misses_after_warmup: list[tuple[str, int]] = []
        ftl_registry.register_counter_reset(self)

    def get(self, m: int, phase: str):
        """(bucketed m, BlockPlan-or-None) for one lookup."""
        mb = 1 if phase == "decode" else M.bucket_m(m, self.buckets)
        key = (self.cfg, mb, self.dtype, self.target, phase)
        if key in self._plans:
            self.hits += 1
            return mb, self._plans[key]
        self.misses += 1
        if self.warmed:
            self.misses_after_warmup.append((phase, mb))
        _, plan = M.serve_plan(self.cfg, m=mb, dtype=self.dtype,
                               target=self.target, phase=phase,
                               buckets=self.buckets, device=self.device)
        self._plans[key] = plan
        return mb, plan

    def warmup(self) -> None:
        for b in self.buckets:
            self.get(b, "prefill")
        self.get(1, "decode")
        self.warmed = True

    def counters(self) -> dict:
        return {
            "plans": len(self._plans),
            "hits": self.hits,
            "misses": self.misses,
            "misses_after_warmup": len(self.misses_after_warmup),
        }

    def reset_counters(self) -> None:
        """Back to the just-constructed state (``registry.
        clear_plan_caches``): the held plans are dropped too."""
        self._plans.clear()
        self.hits = 0
        self.misses = 0
        self.warmed = False
        self.misses_after_warmup.clear()


def _default_buckets(max_seq: int, block_size: int) -> tuple[int, ...]:
    rungs = [b for b in M.PREFILL_BUCKETS if b <= max_seq]
    if not rungs or rungs[-1] < max_seq:
        rungs.append(max_seq)
    rungs = [b for b in rungs if b % block_size == 0] or [max_seq]
    return tuple(rungs)


def _splice(full: torch.Tensor, one: torch.Tensor, slot: int, ax: int,
            *, ring: bool = False) -> None:
    """Write a batch-1 request cache into ``slot`` of the batch cache, in
    place, zero-padding its seq dim up to the engine's ``max_seq``.

    A local-window ring (``ring``) comes out of the prefill ``window``
    rows long; with ``max_seq < window`` the slot holds ``max_seq`` of
    them, and the rows past ``max_seq`` are the prefill's zero padding (a
    prompt fills at most ``max_seq`` positions), so they are left out.
    Any other leaf longer than its slot raises."""
    dst = full.select(ax, slot)
    src = one.select(ax, 0)
    n = src.shape[ax]
    if n > dst.shape[ax]:
        if not ring:
            raise ValueError(f"prefill cache of {n} rows does not fit the "
                             f"slot's {dst.shape[ax]}")
        n = dst.shape[ax]
    dst.zero_()
    dst.narrow(ax, 0, n).copy_(src.narrow(ax, 0, n))


class ServeEngine:
    """Fixed-slot continuous batching engine (single card).

    ``target`` picks the planning preset (None → the process default);
    ``block_size`` is the paged-KV page length (``paged=False`` forces the
    dense per-slot cache, ``kv_blocks`` shrinks the physical pool below
    ``slots * max_seq / block_size``).  ``device`` None means the CUDA
    card, and raises when there is none; the CPU runs only when asked
    for.  ``obs`` turns on telemetry: span recording, per-step gauges and
    the drift monitor, which prices on ``drift_target`` (None: the
    planning target) within ``drift_band`` (None: ``obs.DEFAULT_BAND``)."""

    def __init__(self, cfg, params, *, batch_slots: int, max_seq: int,
                 eos_id: int = 1, target: hw.Target | None = None,
                 block_size: int = 8, paged: bool | None = None,
                 kv_blocks: int | None = None,
                 buckets: tuple[int, ...] | None = None,
                 device: torch.device | str | None = None,
                 obs: bool = False, drift_target: hw.Target | None = None,
                 drift_band: tuple[float, float] | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos = eos_id
        self.target = target if target is not None else hw.default_target()
        self.block_size = block_size
        self.buckets = (tuple(buckets) if buckets is not None
                        else _default_buckets(max_seq, block_size))
        if any(b > max_seq for b in self.buckets):
            raise ValueError(f"bucket ladder {self.buckets} exceeds "
                             f"max_seq={max_seq}")
        self.active: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int64)

        self.paged = (KV.paged_supported(cfg) if paged is None else paged)
        if self.paged and not KV.paged_supported(cfg):
            raise ValueError(f"{cfg.name!r} cannot use the paged KV cache")
        if self.paged:
            if max_seq % block_size:
                raise ValueError(f"max_seq={max_seq} must be a multiple "
                                 f"of block_size={block_size}")
            if any(b % block_size for b in self.buckets):
                raise ValueError(
                    f"every prefill bucket must be a multiple of "
                    f"block_size={block_size}, got {self.buckets}")
            self.kv = KV.PagedKVCache(cfg, slots=batch_slots,
                                      max_seq=max_seq,
                                      block_size=block_size,
                                      num_blocks=kv_blocks,
                                      device=self.device)
            self.cache = None
        else:
            self.kv = None
            self.cache = M.init_cache(cfg, batch_slots, max_seq,
                                      device=self.device)

        # the bucket ladder + the decode plan, planned ahead: after this,
        # steady state never plans again
        self.plans = PlanCache(cfg, dtype=cfg.dtype, target=self.target,
                               buckets=self.buckets, device=self.device)
        self.plans.warmup()
        _, self.decode_plan = self.plans.get(1, "decode")
        _, self.block_plan = self.plans.get(self.buckets[-1], "prefill")
        self._decode_fn = self._build_decode(self.decode_plan)
        self._decode_fn_plan = self.decode_plan
        self._prefill_fns: dict[int, Any] = {}

        self.stats = {
            "prefills": 0, "decode_steps": 0, "tokens": 0,
            "replans": 0,
            # host seconds inside prefills / decode steps (each ends in a
            # device sync: the sampled token is read back)
            "prefill_s": 0.0, "decode_s": 0.0,
            # logits rows with a NaN or an infinity (0 in a healthy run)
            "nonfinite_logits": 0,
            "bucket_admissions": {},
            "ftl_schedule": (self.block_plan.schedule
                             if self.block_plan else "n/a"),
            "ftl_target": self.target.name,
            "block_exec": "n/a",
        }
        ftl_registry.register_counter_reset(self)

        # telemetry: span recording + per-step gauges + the online drift
        # monitor, all opt-in — a bare engine pays nothing
        self.obs = bool(obs)
        self.drift = None
        if self.obs:
            obslib.enable()
            self.drift = obslib.DriftMonitor(
                target=drift_target if drift_target is not None
                else self.target,
                **({"band": drift_band} if drift_band else {}))
            self._g_active = obslib.gauge(
                "serve_active_slots", "slots currently decoding")
            self._g_queue = obslib.gauge(
                "serve_queue_depth", "requests waiting for a slot")
            self._g_kv_free = obslib.gauge(
                "serve_kv_free_blocks", "paged-KV free physical blocks")
            self._g_kv_occ = obslib.gauge(
                "serve_kv_page_occupancy",
                "fraction of the paged-KV pool in use")
            self._c_evict = obslib.counter(
                "serve_evictions_total", "slots freed (EOS/max-len)")
            self._h_step = obslib.histogram(
                "serve_decode_step_seconds", "wall-clock per decode step")
            self._register_obs_collector()

    def _register_obs_collector(self) -> None:
        """Re-express ``plan_report()``/``stats`` on the metrics registry
        at collect time.  Weakly bound: a dead engine's collector is a
        no-op, never a leak."""
        ref = weakref.ref(self)

        def _collect(reg) -> None:
            eng = ref()
            if eng is None:
                return
            g_stat = reg.gauge("serve_stats",
                               "ServeEngine.stats re-expressed", ("stat",))
            for k in ("prefills", "decode_steps", "tokens", "replans"):
                g_stat.labels(stat=k).set(eng.stats[k])
            g_pc = reg.gauge("serve_plan_cache",
                             "serving PlanCache counters", ("field",))
            for k, v in eng.plans.counters().items():
                g_pc.labels(field=k).set(v)
            rep = eng.plan_report()
            g_plan = reg.gauge(
                "serve_plan_segments",
                "planned segments per serving regime (0 = no plan)",
                ("phase", "schedule"))
            for phase in ("prefill", "decode"):
                e = rep[phase]
                if e is not None:
                    g_plan.labels(phase=phase, schedule=e["schedule"]) \
                        .set(len(e["cuts"]) + 1)
            reg.gauge("serve_decode_differs_from_prefill",
                      "1 when the decode DP picked different cuts") \
                .set(float(rep["decode_differs_from_prefill"]))

        obslib.register_collector(_collect)

    def reset_counters(self) -> None:
        """Called by ``registry.clear_plan_caches``: the replan counter
        tracks misses of the (just reset) plan cache."""
        self.stats["replans"] = 0

    # ------------------------------------------------------------------
    # plan-aware step builders
    # ------------------------------------------------------------------
    def _build_decode(self, plan):
        base = S.make_decode_step(self.cfg, None, plan=plan)
        if not self.paged:
            return base

        def paged_step(params, pool, tables, tok, pos, wblk, woff):
            dense = KV.gather_dense(pool, tables)
            logits, new_dense = base(params, dense, tok, pos)
            return logits, KV.scatter_token(pool, new_dense, pos, wblk,
                                            woff)

        return paged_step

    def _prefill_fn(self, bucket: int, plan):
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            # paged caches splice page-aligned bucket-length caches; the
            # dense path pads to max_seq at splice time instead
            fn = S.make_prefill_step(self.cfg, None, plan=plan)
            self._prefill_fns[bucket] = fn
        return fn

    def plan_report(self) -> dict:
        """Resolved executors + cuts for both serving regimes."""
        def entry(plan, m):
            if plan is None:
                return None
            return {
                "m": m,
                "schedule": plan.schedule,
                "cuts": list(plan.chain.cuts()),
                "executors": executor_block.resolved_executors(plan, m=m),
            }

        pre = entry(self.block_plan, self.buckets[-1])
        dec = entry(self.decode_plan, 1)
        return {
            "target": self.target.name,
            "buckets": list(self.buckets),
            "prefill": pre,
            "decode": dec,
            "decode_differs_from_prefill": bool(
                pre and dec and pre["cuts"] != dec["cuts"]),
            "plan_caches": ftl_registry.plan_cache_stats(),
        }

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def warmup_compile(self, extras: dict[str, Any] | None = None) -> None:
        """Run every bucket's prefill step and one decode step once before
        serving (first-launch costs: the kernel library's load, library
        handles, the allocator), so latency measures serving.  Engine
        state is untouched: the paged decode writes only the scratch page
        and the dense one a copy of the cache.  ``extras``: as
        :meth:`run`'s."""
        extras = extras or {}
        for b in self.buckets:
            _, plan = self.plans.get(b, "prefill")
            fn = self._prefill_fn(b, plan)
            tokens = torch.zeros((1, b), dtype=torch.long, device=self.device)
            fn(self.params, {"tokens": tokens, **extras}, b - 1)
        tok = torch.zeros((self.slots, 1), dtype=torch.long,
                          device=self.device)
        zero = torch.zeros((self.slots,), dtype=torch.long,
                           device=self.device)
        if self.paged:
            self._decode_fn(self.params, self.kv.pool, self.kv.table_array(),
                            tok, zero, zero, zero)
        else:
            self._decode_fn(self.params, M.tree_map(torch.clone, self.cache),
                            tok, zero)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def execute_block_plan(self):
        """Run the stored prefill BlockPlan for real at the serving shape.

        Executes one transformer block of the engine's own parameters
        through ``registry.run_block`` on a (1, max_seq, d_model)
        activation, requalifying every binding on this device; records
        the resolved executors and the wall-clock time in ``stats`` and,
        with telemetry on, the block's modeled/measured ratio on the
        drift monitor (``drift_ratio``).  Returns None when the model has
        no plannable block."""
        if self.block_plan is None:
            return None
        p, kind = self._first_block_params()
        if p is None:
            return None
        cfg = self.cfg
        window = cfg.local_window if kind == "local" else None
        gen = torch.Generator(device=self.device).manual_seed(0)
        x = torch.randn((1, self.max_seq, cfg.d_model), generator=gen,
                        device=self.device).to(torch_dtype(cfg.dtype))
        positions = torch.arange(self.max_seq, device=self.device)

        def run():
            return ftl_registry.run_block(self.block_plan, p, x,
                                          positions=positions, window=window)

        run()                                   # first launches
        self._sync()
        t0 = time.perf_counter()
        with obslib.span("serve:block_exec", "exec"):
            y = run()
            self._sync()
        dt = time.perf_counter() - t0
        entry = {
            "ms": 1e3 * dt,
            "executors": executor_block.resolved_executors(
                self.block_plan, m=self.max_seq,
                dtype=ftl_registry.dtype_name(x.dtype)),
            "finite": bool(torch.isfinite(y).all()),
        }
        self.stats["block_exec"] = entry
        if self.drift is not None:
            # the gated drift feed: a whole planned block, wall-clocked at
            # the serving shape
            entry["drift_ratio"] = self.drift.observe_chain(
                self.block_plan, dt, name="block_exec", kind="block")
        return entry

    def _first_block_params(self):
        """(params, mixer kind) of the first plan-executable layer: the
        first attention(+MLP) layer, else (hybrid stacks whose plan is
        MLP-only) the first MLP-bearing one; (None, None) when no layer
        can execute the plan (a pure-SSM stack: no attention, no MLP)."""
        kinds, n_full, rem_kinds = M._layer_split(self.cfg)
        if n_full:
            pool = [(k, f"pos{i}") for i, k in enumerate(kinds)]

            def get(key):
                # slice only this position's subtree, not the whole stack
                return M.tree_map(lambda a: a[0],
                                  self.params["layers"][key])
        elif rem_kinds:
            pool = [(k, f"rem{i}") for i, k in enumerate(rem_kinds)]

            def get(key):
                return self.params["rem"][key]
        else:
            return None, None
        for kind, key in pool:
            if kind in ("attn", "local"):
                return get(key), kind
        if self.cfg.d_ff and not self.cfg.is_moe:
            kind, key = pool[0]
            return get(key), kind
        return None, None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _admit(self, req: Request, slot: int, extras: dict[str, Any]
               ) -> bool:
        """Prefill one request at its bucketed length and splice its cache
        into the slot.  Returns False (admitting nothing) when the paged
        pool cannot cover the bucket — the request stays queued."""
        plen = len(req.prompt)
        if plen > self.buckets[-1]:
            raise ValueError(f"request {req.rid}: prompt of {plen} tokens "
                             f"exceeds the largest bucket "
                             f"{self.buckets[-1]}")
        obslib.begin("serve:admit", "serve")
        bucket, plan = self.plans.get(plen, "prefill")
        req.bucket = bucket
        if self.paged and not self.kv.allocate(slot, bucket):
            obslib.end()
            return False

        t0 = time.perf_counter()
        padded = np.zeros(bucket, np.int64)
        padded[:plen] = req.prompt
        fn = self._prefill_fn(bucket, plan)
        # bucket padding is on the right; the prompt's real last token
        # sits at plen-1 and decode overwrites the pad KV in place
        with obslib.span(f"serve:prefill:m{bucket}", "serve"):
            logits, cache1 = fn(self.params,
                                {"tokens": self._tensor(padded)[None],
                                 **extras}, plen - 1)
            first = int(torch.argmax(logits[0, -1]))
            self._check_finite(logits)
        self.stats["prefill_s"] += time.perf_counter() - t0

        if self.paged:
            self.kv.write_prefill(slot, cache1, bucket)
        else:
            # the leaves of a layer, in order: KV (a bucket long, padded to
            # max_seq here), a local ring, recurrent state, or a context's
            # K and V (``cross``; an encoder–decoder's layers hold ``self``
            # and ``cross``), which fill their slot and are never cut
            kinds, _, rem_kinds = M._layer_split(self.cfg)
            for top, sub in self.cache.items():
                ax, layer_kinds = ((1, kinds) if top == "layers"
                                   else (0, rem_kinds))
                for kind, (key, layer) in zip(layer_kinds, sub.items()):
                    for full, one in zip(M.tree_leaves(layer),
                                         M.tree_leaves(cache1[top][key])):
                        _splice(full, one, slot, ax, ring=kind == "local")

        self.active[slot] = req
        self.pos[slot] = plen
        req.out.append(first)
        req.t_admitted = time.perf_counter()
        self.stats["prefills"] += 1
        adm = self.stats["bucket_admissions"]
        adm[bucket] = adm.get(bucket, 0) + 1
        obslib.end()  # serve:admit
        return True

    def _check_finite(self, logits: torch.Tensor) -> None:
        bad = ~torch.isfinite(logits.reshape(logits.shape[0], -1)).all(-1)
        self.stats["nonfinite_logits"] += int(bad.sum())

    # ------------------------------------------------------------------
    def _evict(self, slot: int) -> None:
        with obslib.span("serve:evict", "serve"):
            self.active[slot] = None
            self.pos[slot] = 0
            if self.paged:
                self.kv.release(slot)
        if self.obs:
            self._c_evict.inc()

    def step(self):
        """One batched decode step for all active slots (each at its own
        position)."""
        obslib.begin("serve:decode_step", "serve")
        t0 = time.perf_counter()
        # steady-state plan lookup: after warmup this always hits; a
        # changed plan object would rebuild the step — counted as a replan
        _, plan = self.plans.get(1, "decode")
        if plan is not self._decode_fn_plan:
            self._decode_fn = self._build_decode(plan)
            self._decode_fn_plan = plan
            self.decode_plan = plan
            self.stats["replans"] += 1

        tok = np.zeros((self.slots, 1), np.int64)
        live = np.zeros(self.slots, bool)
        for i, r in enumerate(self.active):
            if r is not None and not r.done:
                tok[i, 0] = r.out[-1]
                live[i] = True

        pos = self._tensor(self.pos)
        if self.paged:
            wblk = np.zeros(self.slots, np.int64)
            woff = np.zeros(self.slots, np.int64)
            for i in range(self.slots):
                if live[i]:
                    if not self.kv.allocate(i, int(self.pos[i]) + 1):
                        raise RuntimeError(
                            f"KV pool exhausted growing slot {i} at pos "
                            f"{int(self.pos[i])} "
                            f"({self.kv.free_blocks} free blocks)")
                    wblk[i], woff[i] = self.kv.write_coords(
                        i, int(self.pos[i]))
                # dead slots keep (0, 0): the scratch page
            logits, _ = self._decode_fn(
                self.params, self.kv.pool, self.kv.table_array(),
                self._tensor(tok), pos, self._tensor(wblk),
                self._tensor(woff))
        else:
            logits, self.cache = self._decode_fn(
                self.params, self.cache, self._tensor(tok), pos)

        nxt = torch.argmax(logits[:, 0], -1).cpu().numpy()
        self._check_finite(logits[torch.as_tensor(live, device=self.device)])
        now = time.perf_counter()
        self.stats["decode_s"] += now - t0
        for i, r in enumerate(self.active):
            if r is None or r.done:
                continue
            t = int(nxt[i])
            r.out.append(t)
            self.pos[i] += 1
            self.stats["tokens"] += 1
            if t == self.eos or len(r.out) >= r.max_new \
                    or self.pos[i] >= self.max_seq - 1:
                r.done = True
                r.t_done = now
        self.stats["decode_steps"] += 1
        obslib.end()  # serve:decode_step
        if self.obs:
            self._observe_step(time.perf_counter() - t0)

    def _observe_step(self, dt: float) -> None:
        """Per-step gauges + a sampled drift row (obs-enabled engines)."""
        self._h_step.observe(dt)
        self._g_active.set(sum(1 for r in self.active
                               if r is not None and not r.done))
        if self.paged:
            free = self.kv.free_blocks
            self._g_kv_free.set(free)
            self._g_kv_occ.set(1.0 - free / max(self.kv.num_blocks, 1))
        if (self.drift is not None and self.decode_plan is not None
                and self.stats["decode_steps"] % _DRIFT_SAMPLE_EVERY == 0):
            # report-only row: a decode step runs the per-block plan
            # n_layers times (plus head and dispatch the block plan is
            # never charged for), so the modeled side is scaled to match;
            # the whole-block rows of execute_block_plan are the gated ones
            self.drift.observe_chain(
                self.decode_plan, dt, name="decode_step", kind="decode",
                scale=max(self.cfg.n_layers, 1))

    def run(self, requests: list[Request],
            extras: dict[str, Any] | None = None,
            arrivals: list[float] | None = None) -> list[Request]:
        """Serve ``requests`` to completion.

        ``extras``: extra model inputs shared by every request, batch 1 on
        the engine's device (``frames`` (1, encoder_seq, d_model) for an
        encoder–decoder, ``image_embeds`` (1, n_image_tokens, d_model) for
        the VLM), as in the reference.  ``arrivals`` (seconds from run
        start, one per request, sorted) switches to an open-loop arrival
        process; None keeps everything arriving at t=0."""
        extras = extras or {}
        if arrivals is not None:
            if len(arrivals) != len(requests):
                raise ValueError("one arrival time per request")
            for r, a in zip(requests, arrivals):
                r.arrival_s = float(a)
        t0 = time.perf_counter()
        for r in requests:
            r.t_arrival = t0 + r.arrival_s
        queue = list(requests)
        done: list[Request] = []
        while queue or any(r is not None for r in self.active):
            now = time.perf_counter()
            if self.obs:
                self._g_queue.set(len(queue))
            admitted_any = False
            for i in range(self.slots):
                r = self.active[i]
                if r is not None and r.done:
                    done.append(r)
                    self._evict(i)
                if (self.active[i] is None and queue
                        and queue[0].t_arrival <= now):
                    if self._admit(queue[0], i, extras):
                        queue.pop(0)
                        admitted_any = True
                    else:
                        break       # paged pool full: wait for evictions
            have_live = any(r is not None and not r.done
                            for r in self.active)
            if not have_live:
                if admitted_any:
                    continue
                if queue:
                    wait = queue[0].t_arrival - time.perf_counter()
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                        continue
                    if all(r is None for r in self.active):
                        raise RuntimeError(
                            "deadlock: KV pool too small to admit request "
                            f"{queue[0].rid} with every slot empty")
                continue
            self.step()
        return done


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0
                     ) -> list[float]:
    """Cumulative exponential inter-arrival times (open-loop process)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
    return list(np.cumsum(gaps))


def serving_ftl_mode(cfg) -> str:
    """The ``ftl_mode`` a config is served with.

    ``'auto'`` for an ungated MLP: the planner's ``partial`` schedule binds
    ``cuda_partial_mlp`` (``gemm_act``, then ``gemm``) at every prefill
    bucket on the card.  ``'fused'`` for a gated one: the partial kernels
    take no gate, and under ``'auto'`` the planner would bind the gated
    MLP to ``torch_partial_scan_mlp``, which a run on the card refuses
    (``executor_block._stage_executor``; ROADMAP, finding 2).  A MoE
    config's shared experts are one gated MLP, run outside any plan with
    the config's mode (as the reference's ``moe_layer`` runs them), so a
    gated shared MLP takes ``'fused'`` too: the fused-MLP kernel at M =
    the tokens routed together.  ``'off'`` for a stack with no MLP
    (xLSTM; a MoE without shared experts): there is nothing to fuse.
    So whisper-base (ungated gelu) is served ``'auto'``: its decoder's
    MLPs bind ``cuda_partial_mlp`` at every bucket and at M = 1, while
    its encoder's, at M = encoder_seq (1500), resolve to
    ``torch_unfused_mlp`` on the ``h100`` target; and
    llama-3.2-vision-90b (gated silu) ``'fused'``."""
    if cfg.is_moe:
        return "fused" if cfg.shared_d_ff and cfg.mlp_gated else "off"
    if not cfg.d_ff:
        return "off"
    return "fused" if cfg.mlp_gated else "auto"


def main(argv: list[str] | None = None) -> ServeEngine:
    """The serve CLI; returns the engine it served with (its ``stats``,
    ``drift`` and ``plan_report()`` for tools)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--target", default=None,
                    help="planning target preset (default: auto-detect)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged-KV page length in tokens")
    ap.add_argument("--dense-kv", action="store_true",
                    help="force the dense per-slot cache")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrival rate (req/s); "
                    "default: all requests arrive at t=0")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                    "only when asked for)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-tracing timeline of the decode "
                    "plan's simulated schedule to this path (with --obs: "
                    "the merged live+modeled timeline, written post-run)")
    ap.add_argument("--obs", action="store_true",
                    help="enable runtime telemetry (spans, gauges, the "
                    "online drift monitor)")
    ap.add_argument("--obs-trace", default=None,
                    help="write the merged live+modeled Perfetto "
                    "timeline to this path after the run (implies --obs)")
    ap.add_argument("--obs-metrics", default=None,
                    help="write a Prometheus text exposition of the "
                    "metrics registry to this path after the run "
                    "(implies --obs)")
    args = ap.parse_args(argv)
    if args.obs_trace or args.obs_metrics:
        args.obs = True
    if args.trace and args.obs_trace and args.trace == args.obs_trace:
        ap.error("--trace and --obs-trace point at the same path "
                 f"({args.trace}); they would silently overwrite each "
                 "other — give them distinct paths")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, ftl_mode=serving_ftl_mode(cfg))
    params = M.init_params(cfg, args.seed, device=device)
    # the stub frontends' inputs, zeros as in the reference
    extras: dict[str, torch.Tensor] = {}
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.zeros(
            (1, cfg.n_image_tokens, cfg.d_model), dtype=dt, device=device)
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                       dtype=dt, device=device)

    rng = np.random.default_rng(args.seed)
    # mixed prompt lengths exercise the bucket ladder + per-slot decode
    lens = rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1,
                        size=args.requests)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size,
                                    size=int(lens[i])).astype(np.int32),
                    args.max_new)
            for i in range(args.requests)]
    target = hw.get_target(args.target) if args.target else None
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=args.max_seq, target=target,
                      block_size=args.block_size,
                      paged=False if args.dense_kv else None, device=device,
                      obs=args.obs)
    report = eng.plan_report()
    print(f"FTL serving plans on {report['target']} "
          f"(buckets {report['buckets']}, "
          f"{'paged' if eng.paged else 'dense'} KV, device {device}):")
    for phase in ("prefill", "decode"):
        e = report[phase]
        if e is None:
            print(f"  {phase}: no plannable block")
            continue
        print(f"  {phase} @ m={e['m']}: schedule={e['schedule']} "
              f"cuts={e['cuts']} executors={e['executors']}")
    if report["decode_differs_from_prefill"]:
        print("  decode cuts differ from prefill (memory-bound m=1 DP)")
    exec_stats = eng.execute_block_plan()
    if exec_stats is not None:
        print(f"block plan executed @ m={args.max_seq}: "
              f"{exec_stats['ms']} ms, executors "
              f"{exec_stats['executors']}"
              + (f", modeled/measured {exec_stats['drift_ratio']}"
                 if "drift_ratio" in exec_stats else ""))
    if args.trace and not args.obs:
        # modeled-only timeline (pre-run: it needs no live spans); with
        # --obs the trace is written post-run as the merged view instead
        from repro_torch.sim import write_chrome_trace
        plan = eng.decode_plan or eng.block_plan
        if plan is not None:
            write_chrome_trace(plan, args.trace)
            print(f"decode-plan timeline written to {args.trace}")

    eng.warmup_compile(extras)
    arrivals = (poisson_arrivals(args.requests, args.arrival_rate,
                                 args.seed)
                if args.arrival_rate else None)
    t0 = time.perf_counter()
    done = eng.run(reqs, extras, arrivals=arrivals)
    dt = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in done)
    p50 = lat[len(lat) // 2] if lat else 0.0
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0
    print(f"served {len(done)} requests, {eng.stats['tokens']} tokens "
          f"in {dt}s ({eng.stats['tokens'] / max(dt, 1e-9)} tok/s); "
          f"{eng.stats['decode_steps']} decode steps, "
          f"{eng.stats['prefills']} prefills, "
          f"p50 {1e3 * p50} ms / p99 {1e3 * p99} ms")
    pc = eng.plans.counters()
    print(f"plan cache: {pc['plans']} plans, {pc['hits']} hits, "
          f"{pc['misses']} misses ({pc['misses_after_warmup']} after "
          f"warmup), {eng.stats['replans']} decode replans")
    for r in done[:3]:
        print(f"  req {r.rid}: {len(r.out)} tokens: {r.out[:10]}...")

    if args.obs:
        if eng.drift is not None and eng.drift.n_observed:
            st = eng.drift.status()
            print(f"drift monitor on {st['target']}: geomean "
                  f"modeled/measured {st['geomean_ratio']} "
                  f"({'in' if st['in_band'] else 'OUT OF'} band "
                  f"{tuple(st['band'])}, {st['n_observed']} observations)")
        plan = eng.decode_plan or eng.block_plan
        for path in (args.obs_trace, args.trace):
            if path:
                obslib.write_merged_trace(path, chain=plan)
                print(f"merged live+modeled timeline written to {path}")
        if args.obs_metrics:
            obslib.write_prometheus(args.obs_metrics)
            print(f"Prometheus metrics written to {args.obs_metrics}")
    return eng


if __name__ == "__main__":
    main()
