#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

Run from the root of a checkout, on a machine with the card, ``nvcc`` and
PyTorch built for CUDA::

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit code):

1. Set-up: build the CUDA kernels from ``src/repro_torch/csrc`` into
   ``build/kernels`` and print the card's name and power limit.
2. Kernels against their plain PyTorch versions, in bf16 at the serving
   path's shapes: max |difference| against the stated tolerance, and each
   kernel's time (CUDA events, median of 20 launches, L2 flushed before
   each) beside its roofline bound, its plain version's time and, where
   one exists, the time of the one PyTorch call that computes the same
   function.  The fused MLP's planned F slice is also timed beside its
   neighbours, each with the bytes of its fp32 partials.
3. Serve llama3.2-3b at full width (28 layers, bf16, random weights from a
   seed) with ``ftl_mode='fused'`` on the ``h100`` planning target: 8
   requests, 4 slots, paged KV.  The launch counters are set to 0 just
   before this run and read just after; every kernel must have launched
   and must show in the profiler's device-kernel list.  A second,
   unprofiled run gives the serving times.
4. The served path against the plain path: one 256-token prompt prefilled
   with ``ftl_mode='fused'`` and ``'off'``.
5. One JSON line per the kernels, then the result line.

It exits non-zero, printing no result, when no CUDA device is visible,
and when it stands alone without the rest of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# dense bf16 tensor-core FLOP/s, at the 700 W power limit
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain version, elementwise: |k - p| <= ATOL + RTOL * |p| (the
# JAX kernel tests' bf16 tolerance: both round fp32 sums to bf16, in
# different orders)
ATOL = RTOL = 2e-2

N_TIMED = 20


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call: CUDA events around it, the L2 flushed
    before it, and a device-side wait in front so that the host has
    enqueued the whole call before the start event fires."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def ms(self, fn, n: int = N_TIMED) -> float:
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BPS, flops / BF16_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(out: torch.Tensor, want: torch.Tensor, label: str) -> float:
    check(out.shape == want.shape and out.dtype == want.dtype,
          f"{label}: {tuple(out.shape)}/{out.dtype} vs "
          f"{tuple(want.shape)}/{want.dtype}")
    o, w = out.float(), want.float()
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    err = (o - w).abs()
    ok = bool((err <= ATOL + RTOL * w.abs()).all())
    max_err = float(err.max())
    print(f"  {label}: max|kernel - plain| {max_err} (tolerance "
          f"{ATOL} + {RTOL}*|plain|, max|plain| {float(w.abs().max())}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version")
    return max_err


def kernel_cases(dev, timer):
    from repro_torch.core import hw
    from repro_torch.kernels import flash_attention, fused_mlp, gemm, ref

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    results = {"gemm": [], "flash_attention": [], "fused_mlp": []}

    for m, k, n in ((1024, 3072, 3072), (1024, 3072, 1024)):
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        label = f"gemm ({m}x{k})@({k}x{n})"
        err = compare(gemm.gemm(x, w), ref.gemm(x, w), label)
        b, why = bound_ms(2 * (m * k + k * n + m * n), 2 * m * n * k)
        results["gemm"].append(dict(
            shape=[m, k, n], max_abs_err=err,
            ms=timer.ms(lambda: gemm.gemm(x, w)),
            plain_ms=timer.ms(lambda: ref.gemm(x, w)),
            library_ms=timer.ms(lambda: torch.matmul(x, w)),
            bound_ms=b, bound_by=why))

    b_, hq, hk, dh = 1, 24, 8, 128
    for t in (1024, 200):
        q, kk, v = (randn(b_, hq, t, dh), randn(b_, hk, t, dh),
                    randn(b_, hk, t, dh))
        label = f"flash_attention B={b_} Hq={hq} Hk={hk} T={t} causal"
        err = compare(flash_attention.flash_attention(q, kk, v, causal=True),
                      ref.attention(q, kk, v, causal=True), label)
        pairs = t * (t + 1) // 2          # unmasked (query, key) pairs
        b, why = bound_ms(2 * (2 * q.numel() + 2 * kk.numel()),
                          4 * b_ * hq * dh * pairs)
        results["flash_attention"].append(dict(
            shape=[b_, hq, hk, t, dh], max_abs_err=err,
            ms=timer.ms(lambda: flash_attention.flash_attention(
                q, kk, v, causal=True)),
            plain_ms=timer.ms(lambda: ref.attention(q, kk, v, causal=True)),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q, kk, v, is_causal=True, enable_gqa=True)),
            bound_ms=b, bound_by=why))

    k_, f_, n_ = 3072, 8192, 3072
    w1, wg = randn(k_, f_, scale=k_ ** -0.5), randn(k_, f_, scale=k_ ** -0.5)
    w2 = randn(f_, n_, scale=f_ ** -0.5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (1024, 256, 4):
        x = randn(m, k_)
        label = f"fused_mlp M={m} {k_}->{f_}->{n_} silu gated"
        err = compare(fused_mlp.fused_mlp(x, w1, w2, wg, act="silu"),
                      ref.mlp(x, w1, w2, wg, act="silu"), label)
        b, why = bound_ms(2 * (m * k_ + 2 * k_ * f_ + f_ * n_ + m * n_),
                          2 * m * k_ * f_ * 2 + 2 * m * f_ * n_)
        # the planned F slice against its neighbours: each one's time
        # beside the bytes of its fp32 partials in device memory and the
        # bytes h would cost there (bf16, written and read once)
        tgt = hw.default_target()
        _, bf = fused_mlp.plan_blocks(m, k_, f_, n_, tgt, n_sm, True)
        sweep = {}
        for alt in (bf // 4, bf // 2, bf, 2 * bf):
            if alt < fused_mlp.F_ALIGN or \
                    alt not in fused_mlp.feasible_block_f(f_, tgt):
                continue
            sweep[str(alt)] = timer.ms(lambda: fused_mlp.fused_mlp(
                x, w1, w2, wg, act="silu", block_f=alt))
            print(f"  fused_mlp M={m} block_f={alt}"
                  f"{' (planned)' if alt == bf else ''}: {sweep[str(alt)]} "
                  f"ms, partials {fused_mlp.partial_bytes(m, n_, f_, alt)} B "
                  f"in device memory (h would be {2 * 2 * m * f_} B)")
        results["fused_mlp"].append(dict(
            shape=[m, k_, f_, n_], max_abs_err=err, block_f=bf,
            ms=timer.ms(lambda: fused_mlp.fused_mlp(x, w1, w2, wg,
                                                     act="silu")),
            plain_ms=timer.ms(lambda: ref.mlp(x, w1, w2, wg, act="silu")),
            library_ms=None, bound_ms=b, bound_by=why,
            block_f_ms=sweep))

    for name, cases in results.items():
        for c in cases:
            lib = ("" if c["library_ms"] is None
                   else f", one PyTorch call {c['library_ms']} ms")
            print(f"  {name} {c['shape']}: kernel {c['ms']} ms, bound "
                  f"{c['bound_ms']} ms ({c['bound_by']}), plain "
                  f"{c['plain_ms']} ms{lib}")
    return results


# ---------------------------------------------------------------------------
# phase 3: serve llama3.2-3b at full width
# ---------------------------------------------------------------------------

KERNEL_RE = {"gemm": r"(^|::)gemm_kernel\b",
             "flash_attention": r"(^|::)flash_kernel\b",
             "fused_mlp": r"(^|::)fused_mlp_kernel\b"}


def requests(cfg, seed: int = 0):
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 961, size=8)
    return [Request(i, rng.integers(2, cfg.vocab_size, size=int(n))
                    .astype(np.int32), 32) for i, n in enumerate(lens)]


def serve_phase(dev, modules):
    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("llama3.2-3b"), ftl_mode="fused")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    print(f"  llama3.2-3b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters "
          f"({2 * n_params / 1e9} GB) initialised in "
          f"{time.perf_counter() - t0} s")

    eng = ServeEngine(cfg, params, batch_slots=4, max_seq=1024,
                      block_size=16, target=hw.H100, eos_id=-1, device=dev)
    pool = sum(t.numel() * t.element_size()
               for t in M.tree_leaves(eng.kv.pool))
    print(f"  engine: 4 slots, max_seq 1024, paged KV pool "
          f"{pool / 1e9} GB, buckets {list(eng.buckets)}")
    rep = eng.plan_report()
    for phase in ("prefill", "decode"):
        e = rep[phase]
        print(f"  plan {phase} @ m={e['m']} on {rep['target']}: schedule "
              f"{e['schedule']}, cuts {e['cuts']}, executors "
              f"{e['executors']}")
    want = {"gemm": "cuda_gemm", "attention": "cuda_flash_attention",
            "mlp": "cuda_fused_mlp"}
    check(rep["prefill"]["executors"] == want,
          f"prefill executors {rep['prefill']['executors']} != {want}")
    eng.warmup_compile()

    # --- the main path: counters from 0, under the profiler -------------
    for mod in modules.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    s0 = dict(eng.stats)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        blk = eng.execute_block_plan()
        done = eng.run(requests(cfg))
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = {n: mod.launches for n, mod in modules.items()}
    print(f"  main path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(blk is not None and blk["finite"]
          and blk["executors"] == want, f"block plan execution: {blk}")
    check(len(done) == 8 and all(len(r.out) == 32 for r in done),
          "every request must return 32 tokens: "
          f"{[(r.rid, len(r.out)) for r in done]}")

    kern = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kern.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.time_range.elapsed_us() / 1e3
    check(bool(kern), "the profiler recorded no device kernel")
    for name, rx in KERNEL_RE.items():
        hits = [n for n in kern if re.search(rx, n)]
        check(bool(hits), f"{name} kernel missing from the profiler's "
              f"device-kernel list")
        print(f"  profiler: {name}: {sum(kern[h][0] for h in hits)} "
              f"launches, {sum(kern[h][1] for h in hits)} ms on the device")
    busy = sum(v[1] for v in kern.values())
    print("  profiler: top device kernels (ms, count): " + "; ".join(
        f"{n[:60]} {v[1]} ms x{v[0]}" for n, v in
        sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]))
    print(f"  profiler: device kernel time {busy} ms of {prof_wall_ms} ms "
          f"wall in the profiled run: device busy {busy / prof_wall_ms}")
    print(f"  profiler: {sum(v[0] for v in kern.values())} device kernels "
          f"launched in the profiled run (one execute_block_plan call, "
          f"{eng.stats['prefills'] - s0['prefills']} prefills, "
          f"{eng.stats['decode_steps'] - s0['decode_steps']} decode steps)")

    # --- serving times, unprofiled ---------------------------------------
    blk = eng.execute_block_plan()
    s0 = dict(eng.stats)
    t0 = time.perf_counter()
    done = eng.run(requests(cfg, seed=1))
    wall = time.perf_counter() - t0
    check(len(done) == 8 and all(len(r.out) == 32 for r in done),
          "timed run: every request must return 32 tokens")
    tokens = sum(len(r.out) for r in done)
    steps = eng.stats["decode_steps"] - s0["decode_steps"]
    step_ms = 1e3 * (eng.stats["decode_s"] - s0["decode_s"]) / steps
    ttft = statistics.median(r.ttft_s for r in done)
    print(f"  block plan executed @ m=1024: {blk['ms']} ms, executors "
          f"{blk['executors']}")
    print(f"  served 8 requests, {tokens} tokens in {wall} s: "
          f"{tokens / wall} tokens/s; time to first token p50 "
          f"{1e3 * ttft} ms; {steps} decode steps, {step_ms} ms each; "
          f"{eng.stats['prefills'] - s0['prefills']} "
          f"prefills in {eng.stats['prefill_s'] - s0['prefill_s']} s")
    print(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9}"
          f" GB")
    pc = eng.plans.counters()
    print(f"  plan cache {pc}; decode replans {eng.stats['replans']}; "
          f"non-finite logits rows {eng.stats['nonfinite_logits']}")
    check(eng.stats["replans"] == 0 and pc["misses_after_warmup"] == 0,
          "steady state replanned")
    check(eng.stats["nonfinite_logits"] == 0, "non-finite logits")
    return cfg, params, launches


# ---------------------------------------------------------------------------
# phase 4: the served path against the plain path
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_vs_plain(cfg, params, dev):
    from repro_torch.models import model as M

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(1, 256)),
                           device=dev)
    fused, _ = M.prefill(cfg, params, {"tokens": toks})
    plain, _ = M.prefill(dataclasses.replace(cfg, ftl_mode="off"), params,
                         {"tokens": toks})
    f, p = fused.float().flatten(), plain.float().flatten()
    check(bool(torch.isfinite(f).all() and torch.isfinite(p).all()),
          "non-finite prefill logits")
    d = float((f - p).abs().max())
    sigma = float(p.std())
    tf, tp = int(f.argmax()), int(p.argmax())
    # tolerance: a quarter of the logits' spread -- 28 layers of bf16
    # products rounded in different places (the fused kernel rounds h once
    # from fp32, the plain path after every product)
    tol = 0.25 * sigma
    # the two paths pick one token, or two whose plain logits differ by
    # less than the measured difference (a tie within rounding)
    tie = float(p[tp] - p[tf]) <= 2 * d
    print(f"  prefill 256 tokens: top-1 fused {tf}, plain {tp} "
          f"({'agree' if tf == tp else 'differ'}); max|dlogit| {d} "
          f"(tolerance {tol} = 0.25 x std of the plain logits {sigma})")
    check(d <= tol, "fused and plain prefill logits differ beyond tolerance")
    check(tf == tp or tie, "fused and plain prefill pick different tokens")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, flash_attention, fused_mlp, gemm

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== set-up")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"  built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0} s")
    # the planner sizes the fused MLP's F slice from fused_mlp.smem_bytes;
    # it must be the footprint the CUDA launcher asks for
    # and how many blocks share an SM from fused_mlp.blocks_per_sm
    for bf in (64, 128, 256, 512, 1024):
        check(_build.lib().rt_fused_mlp_smem_bytes(bf)
              == fused_mlp.smem_bytes(bf),
              f"fused_mlp footprint at block_f={bf}: Python and CUDA differ")
        check(_build.lib().rt_fused_mlp_blocks_per_sm(bf, 1)
              == fused_mlp.blocks_per_sm(bf),
              f"fused_mlp blocks per SM at block_f={bf}: the planner's "
              f"{fused_mlp.blocks_per_sm(bf)}, the CUDA runtime's "
              f"{_build.lib().rt_fused_mlp_blocks_per_sm(bf, 1)}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
            print("  ptxas:" + line.split("ptxas info    :")[-1])

    print("== kernels against their plain versions (bf16)")
    results = kernel_cases(dev, Timer(dev))

    print("== serve llama3.2-3b, full width, ftl_mode=fused")
    modules = {"gemm": gemm, "flash_attention": flash_attention,
               "fused_mlp": fused_mlp}
    cfg, params, launches = serve_phase(dev, modules)

    print("== served path against the plain path")
    served_vs_plain(cfg, params, dev)
    print(f"  total {time.perf_counter() - t_start} s")

    meta = {
        "gemm": ("src/repro_torch/csrc/gemm.cu",
                 "src/repro/kernels/gemm.py:34"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:82"),
        "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:75"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{k: results[name][0][k] for k in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "shape": results[name][0]["shape"],
         "cases": results[name]}
        for name, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
