"""The port's roofline tooling against the reference's: the shape cells,
``model_flops`` and ``active_params``, ``HW.from_target`` (the reference's
rule on the presets both packages have, NVLink and HBM on ``h100``),
``RooflineReport.row()``, and ``roofline.op_cost`` against
``repro.roofline.hlo_cost`` on the same functions: a matmul, ten
``tanh(h @ w)`` steps and a reduced llama3.2-3b prefill exactly, a
reduced train step's matmul FLOPs within 1%.  Collective bytes on a fake
process group and the memory count are held to hand counts.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import hw as rhw  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402
from repro.train import steps as RS  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptConfig as TOptConfig  # noqa: E402
from repro_torch.roofline import analysis as TA  # noqa: E402
from repro_torch.roofline.op_cost import analyze_step  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHARED_PRESETS = ("tpu_v5e", "cpu_cache", "rv32_l1_l2", "rv32_npu",
                  "rv32_mesh")


# ---------------------------------------------------------------------------
# shapes, model FLOPs
# ---------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert list(tconfigs.SHAPES) == list(rconfigs.SHAPES)
    for name, spec in rconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.get_shape(name)) == \
            dataclasses.asdict(spec)
    assert tconfigs.ShapeSpec("x", "train", 1, 2) == \
        tconfigs.ShapeSpec("x", "train", 1, 2)


@pytest.mark.parametrize("shape", list(rconfigs.SHAPES))
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch, shape):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    got = TA.model_flops(tcfg, tconfigs.get_shape(shape))
    want = RA.model_flops(rcfg, rconfigs.get_shape(shape))
    assert isinstance(got, int) and got == want
    assert TA._mixer_flops_fwd(tcfg, tconfigs.get_shape(shape)) == \
        RA._mixer_flops_fwd(rcfg, rconfigs.get_shape(shape))
    assert TA.active_params(tcfg) == RA.active_params(rcfg)


# ---------------------------------------------------------------------------
# the machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SHARED_PRESETS)
def test_hw_from_target_is_the_references_rule(name):
    got = TA.HW.from_target(thw.get_target(name))
    want = RA.HW.from_target(rhw.get_target(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hw_default_is_the_references():
    assert dataclasses.asdict(TA.DEFAULT_HW) == \
        dataclasses.asdict(RA.DEFAULT_HW)


def test_h100_view_takes_hbm_and_nvlink():
    hw = TA.HW.from_target(thw.H100)
    assert hw == TA.HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                       hbm_bytes=80e9, vmem_bytes=232_448.0,
                       target_name="h100")
    # the reference's rule would have taken L2 as the memory and HBM as
    # the link; a derived target keeps the view
    deeper = thw.H100.with_buffer_depth(3)
    assert TA.HW.from_target(deeper).hbm_bw == 3.35e12
    assert TA.HW.from_target(deeper).target_name == deeper.name
    # NVLink is no planning level
    assert [lv.name for lv in thw.H100.levels] == ["smem", "l2", "hbm"]


ROW_CASES = [
    # tests/test_roofline.py::test_roofline_report_terms
    dict(shape="train_4k", mesh=(16, 16), flops=197e12, byts=819e9,
         coll=int(50e9), mf=1e15, hw=None),
    dict(shape="decode_32k", mesh=(2, 16, 16), flops=3.1e11, byts=7.7e10,
         coll=123_456_789, mf=2.2e14, hw="h100"),
    dict(shape="prefill_32k", mesh=(16, 16), flops=8.0e15, byts=2.0e12,
         coll=0, mf=4.0e16, hw="rv32_npu"),
]


@pytest.mark.parametrize("case", ROW_CASES)
def test_roofline_row_equals_the_reference(case):
    thw_ = TA.DEFAULT_HW if case["hw"] is None else \
        TA.HW.from_target(thw.get_target(case["hw"]))
    rhw_ = RA.HW(**dataclasses.asdict(thw_))
    kw = dict(arch="x", mesh_shape=case["mesh"],
              cost={"flops": case["flops"], "bytes accessed": case["byts"]},
              coll_bytes=case["coll"], model_flops_total=case["mf"])
    got = TA.roofline(shape=tconfigs.get_shape(case["shape"]), hw=thw_, **kw)
    want = RA.roofline(shape=rconfigs.get_shape(case["shape"]),
                       hlo_text=None, hw=rhw_, **kw)
    assert got.row() == want.row()
    for prop in ("t_compute", "t_memory", "t_collective", "t_bound",
                 "useful_flops_ratio", "mfu_bound", "dominant", "chips"):
        assert getattr(got, prop) == getattr(want, prop)
    if case["hw"] is None:
        assert got.t_compute == pytest.approx(1.0)
        assert got.t_memory == pytest.approx(1.0)
        assert got.t_collective == pytest.approx(1.0)
        assert got.chips == 256


def test_collective_stats_from_cost():
    cost = {"collectives_by_kind": {"all-gather": 10.0, "all-reduce": 4.0},
            "collective_count": 3}
    st = TA.CollectiveStats.from_cost(cost)
    assert st.total_bytes == 14 and st.count == 3
    assert st.by_kind == {"all-gather": 10, "all-reduce": 4,
                          "reduce-scatter": 0, "all-to-all": 0,
                          "collective-permute": 0}
    rep = TA.roofline(arch="x", shape="s", mesh_shape=(2,), cost={},
                      coll_stats=st, model_flops_total=1.0)
    assert rep.coll_bytes_per_chip == 14.0 and rep.coll_stats is st


# ---------------------------------------------------------------------------
# op_cost against hlo_cost
# ---------------------------------------------------------------------------

def dot_flops(hlo_text: str) -> int:
    """The dot FLOPs of a compiled module, while bodies times their trip
    counts (``hlo_cost.parse_module``'s computations)."""
    comps, entry = hlo_cost.parse_module(hlo_text)
    memo: dict = {}

    def cost(name):
        if name in memo:
            return memo[name]
        comp, total = comps[name], 0
        for ins in comp.instrs.values():
            if ins.opcode == "dot":
                lhs = comp.instrs[ins.operands[0]].shape
                k = 1
                for d in ins.contracting():
                    k *= lhs.dims[d]
                total += 2 * ins.shape.n_elem * k
            elif ins.opcode == "while":
                total += ins.trip_count() * cost(ins.attr_body())
            elif ins.opcode in ("fusion", "call") \
                    and ins.attr_calls() in comps:
                total += cost(ins.attr_calls())
        memo[name] = total
        return total

    return cost(entry)


def _compiled(fn, *sds) -> str:
    return jax.jit(fn).lower(*sds).compile().as_text()


def test_matmul_equals_hlo_cost():
    f32 = jnp.float32
    hc = hlo_cost.analyze(_compiled(
        lambda a, b: a @ b, jax.ShapeDtypeStruct((256, 512), f32),
        jax.ShapeDtypeStruct((512, 128), f32)))
    got = analyze_step(lambda a, b: a @ b, torch.zeros(256, 512),
                       torch.zeros(512, 128))
    assert got["flops"] == hc["flops"] == 2 * 256 * 512 * 128
    assert got["matmul_flops"] == got["flops"]
    assert got["bytes"] == hc["bytes"] == (256 * 512 + 512 * 128
                                           + 256 * 128) * 4
    assert got["transcendentals"] == hc["transcendentals"] == 0
    assert got["collective_bytes"] == hc["collective_bytes"] == 0


def test_tanh_chain_equals_hlo_cost_trip_counted():
    def jf(x, w):
        def body(h, _):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, x, None, length=10)[0]

    def tf(x, w):
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
        return h

    sds = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    text = _compiled(jf, sds, sds)
    hc = hlo_cost.analyze(text)
    got = analyze_step(tf, torch.zeros(128, 128), torch.zeros(128, 128))
    assert got["matmul_flops"] == dot_flops(text) == 10 * 2 * 128 ** 3
    assert got["transcendentals"] == hc["transcendentals"] == 10 * 128 ** 2


def _tokens(cfg, b=2, t=32):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def test_reduced_llama_prefill_matmul_flops_equal_the_hlo_dots():
    arch = "llama3.2-3b"
    rcfg, tcfg = rconfigs.get_config(arch).reduced(), \
        tconfigs.get_config(arch).reduced()
    tokens = _tokens(rcfg)
    text = _compiled(RS.make_prefill_step(rcfg, None), RM.param_shapes(rcfg),
                     {"tokens": jax.ShapeDtypeStruct(tokens.shape,
                                                     jnp.int32)})
    got = analyze_step(TS.make_prefill_step(tcfg),
                       TM.init_params(tcfg, 0, device="cpu"),
                       {"tokens": torch.from_numpy(tokens)})
    print(f"prefill matmul FLOPs: port {got['matmul_flops']}, reference "
          f"{dot_flops(text)}")
    assert got["matmul_flops"] == dot_flops(text)


def test_reduced_llama_train_matmul_flops_within_one_percent():
    arch = "llama3.2-3b"
    rcfg, tcfg = rconfigs.get_config(arch).reduced(), \
        tconfigs.get_config(arch).reduced()
    tokens = _tokens(rcfg)
    text = _compiled(RS.make_train_step(rcfg, None, ROptConfig()),
                     RS.train_state_shapes(rcfg),
                     {"tokens": jax.ShapeDtypeStruct(tokens.shape,
                                                     jnp.int32)})
    got = analyze_step(TS.make_train_step(tcfg, None, TOptConfig()),
                       TS.init_train_state(tcfg, 0, device="cpu"),
                       {"tokens": torch.from_numpy(tokens)})
    want = dot_flops(text)
    print(f"train matmul FLOPs: port {got['matmul_flops']}, reference "
          f"{want}, ratio {got['matmul_flops'] / want}")
    assert got["matmul_flops"] == pytest.approx(want, rel=0.01)


# ---------------------------------------------------------------------------
# collectives and memory, by hand
# ---------------------------------------------------------------------------

_COLLECTIVES = """
import json, torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed import collectives as C
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.roofline.op_cost import analyze_step

def step(x, g):
    # a (8, 6) fp32 weight, Shard(0) over data and Shard(1) over model: its
    # (4, 3) shard gathered over model then data
    full = C.gather_full(x, (Shard(0), Shard(1)), mesh)
    # a (8, 6) fp32 gradient: reduce-scattered over data (dp, Shard(0)),
    # then narrowed over model; a replicated one all-reduced over data
    r = C.reduce_grad(g, (Shard(0), Shard(1)), mesh)
    a = C.reduce_grad(g, (Replicate(), Replicate()), mesh)
    m = C.dp_mean_(torch.zeros(5, dtype=torch.bfloat16), mesh)
    return full, r, a, m

with fake_mesh((2, 2), ("data", "model")) as mesh:
    res = analyze_step(step, torch.zeros(4, 3), torch.zeros(8, 6))
print(json.dumps({k: res[k] for k in ("collectives_by_kind",
                                      "collective_count",
                                      "collective_bytes")}))
"""


def test_collective_bytes_by_kind_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # all-gather: the (4, 3) shard over model (48 B), then the (4, 6)
    # result over data (96 B); reduce-scatter: the (8, 6) gradient (192 B);
    # all-reduce: the (8, 6) gradient (192 B) and the 5 bf16 (10 B)
    assert got["collectives_by_kind"] == {
        "all-gather": 48 + 96, "reduce-scatter": 192,
        "all-reduce": 192 + 10, "all-to-all": 0, "collective-permute": 0}
    assert got["collective_count"] == 5
    assert got["collective_bytes"] == 48 + 96 + 192 + 192 + 10


def test_memory_count_of_a_hand_counted_chain():
    n = 1000                                   # 4000 B a buffer

    def chain(x):
        y = x * 2                              # +4000: 8000 live
        y = y + 1                              # +4000, then -4000: peak 12000
        z = y.view(10, 100)                    # a view: nothing
        w = torch.exp(z)                       # +4000: 12000 again
        del y, z                               # w's input freed with z
        return w.sum()                         # +4 : 8004, then w freed

    got = analyze_step(chain, torch.zeros(n))
    assert got["argument_size_in_bytes"] == 4000
    assert got["peak_bytes"] == 12000
    assert got["temp_size_in_bytes"] == 8000
    assert got["output_size_in_bytes"] == 4
    assert got["alias_size_in_bytes"] == 0
    assert got["flops"] == 3 * n + n           # mul, add, exp; sum's n
    assert got["transcendentals"] == n
    # mul, add, exp: read 4000, write 4000 each; sum: read 4000, write 4
    assert got["bytes"] == 3 * 8000 + 4004


def test_memory_count_of_an_in_place_update():
    def update(p, g):
        p.add_(g, alpha=-0.1)                  # in place: no new storage
        return p

    p, g = torch.zeros(256), torch.ones(256)
    got = analyze_step(update, p, g)
    assert got["argument_size_in_bytes"] == 2048
    assert got["temp_size_in_bytes"] == 0
    assert got["output_size_in_bytes"] == got["alias_size_in_bytes"] == 1024
    assert got["flops"] == 256


def test_memory_count_sees_an_empty_buffer():
    """A buffer a kernel wrapper allocates with ``torch.empty`` and fills
    outside PyTorch's ops is live memory, though it moves no bytes."""
    def wrapper(x):
        part = torch.empty(2048, dtype=torch.float32)     # 8192 B
        y = torch.empty_like(x)                           # 4000 B
        del part
        return y

    got = analyze_step(wrapper, torch.zeros(1000))
    assert got["peak_bytes"] == 4000 + 8192 + 4000
    assert got["temp_size_in_bytes"] == 8192 + 4000
    assert got["output_size_in_bytes"] == 4000
    assert got["bytes"] == 0 and got["flops"] == 0


# ---------------------------------------------------------------------------
# loops priced by trips
# ---------------------------------------------------------------------------

def _priced_and_unrolled(fn, *args):
    """``fn`` traced on fake tensors with its ``steps`` loops run whole
    and priced by trips, each on fresh copies of ``args``, after a first
    trace of each (a shape's first trace under ``FakeTensorMode`` may keep
    a storage alive a little longer)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = []
    with FakeTensorMode():
        for loops in (False, True, False, True):
            fresh = [torch.empty(a.shape, dtype=a.dtype).requires_grad_(
                a.requires_grad) for a in args]
            out.append(analyze_step(fn, *fresh, loops=loops))
    return out[2:]


def _grad_loop(w):
    """A weight used by every step and a carry kept in a list, under
    autograd: its gradient is summed over the steps."""
    from repro_torch.roofline.op_cost import pad_steps, steps

    h, hs = torch.zeros(2, 16), []
    for _ in steps(12):
        h = torch.tanh(h @ w)
        hs.append(h)
    pad_steps(hs, 12)
    torch.stack(hs).sum().backward()


def _mlstm_grad(q, i):
    from repro_torch.kernels import ops
    ops.mlstm(q, q, q, i, i).float().sum().backward()


# (function, argument shapes, arguments need a gradient): every count
# exact; the peak within 5%, a step's locals here: where a checkpoint's
# recomputation stops inside a priced loop (the mLSTM's plain backward
# recomputes each chunk and stops at the last tensor it needs) the steps
# that did not run keep what step 2 keeps at the end of the loop, a little
# less than the last step's locals at the stop (3.5% of the peak in
# ``mlstm_grad``); repeated traces give the same peak byte for byte
# (``test_loop_peak_is_the_same_in_repeated_traces``)
PEAK_RTOL = 0.05
LOOP_CASES = {
    "rg_lru_scan": (lambda x, a: ref_rg_lru(x, a), ((2, 12, 16), (2, 12, 16)),
                    False),
    "mlstm_scan": (lambda q, i: ref_mlstm(q, i), ((1, 2, 12, 8), (1, 2, 12)),
                   False),
    "grad_loop": (_grad_loop, ((16, 16),), True),
    "mlstm_grad": (_mlstm_grad, ((1, 2, 12, 8), (1, 2, 12)), True),
}


def ref_rg_lru(x, a):
    from repro_torch.kernels import ref
    return ref.rg_lru_scan(x, a)


def ref_mlstm(q, i):
    from repro_torch.kernels import ref
    return ref.mlstm_scan(q, q, q, i, i)


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_priced_by_trips_as_unrolled(case):
    """Every count of a loop run whole, from four steps run: the forward,
    the backward through autograd (a weight's gradient summed over the
    steps), a Function's plain backward with its checkpointed chunks,
    and the memory the steps keep."""
    fn, shapes, grad = LOOP_CASES[case]
    args = [torch.empty(s).requires_grad_(grad) for s in shapes]
    full, priced = _priced_and_unrolled(fn, *args)
    print(f"{case}: peak {priced['peak_bytes']} priced, "
          f"{full['peak_bytes']} unrolled")
    assert priced["peak_bytes"] == pytest.approx(full["peak_bytes"],
                                                 rel=PEAK_RTOL, abs=0)
    for k in ("peak_bytes", "temp_size_in_bytes"):
        del priced[k], full[k]
    assert priced == full
    assert full["flops"] > 0


REPEATS = 8


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_peak_is_the_same_in_repeated_traces(case):
    """``REPEATS`` traces of each loop in one process, priced by trips
    and unrolled in turn, after a first trace of each: every priced peak
    is the same, byte for byte, and so is every unrolled one.  Storages
    are keyed by a serial number, so a Python ``id`` reused between two
    moments of a priced loop neither drops a storage nor adds one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn, shapes, grad = LOOP_CASES[case]
    peaks = {False: [], True: []}
    with FakeTensorMode():
        for loops in (False, True) * (REPEATS + 1):
            fresh = [torch.empty(s).requires_grad_(grad) for s in shapes]
            peaks[loops].append(
                analyze_step(fn, *fresh, loops=loops)["peak_bytes"])
    for loops, got in peaks.items():
        assert len(set(got[1:])) == 1, (loops, got)


def test_steps_is_range_outside_a_pricing_trace():
    from repro_torch.roofline.op_cost import OpCost, pad_steps, steps
    assert list(steps(7)) == list(range(7))
    with OpCost():                       # counts, runs every step
        assert list(steps(7)) == list(range(7))
    hs = [torch.zeros(1)] * 3
    pad_steps(hs, 3)
    assert len(hs) == 3
