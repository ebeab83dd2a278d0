"""The port's mesh capture against the JAX package's, on the planner only.

``repro_torch.distributed.mesh_capture`` is a copy of the reference's
over the port's planner.  For every config in ``configs.ARCHS`` at
``mesh_size`` 1, 2, 4, 8 and 16, on the ``tpu_v5e`` and ``rv32_mesh``
presets, at m = 32 tokens:

* ``shard_spec`` and ``capture_block``: the same graph (ops, tensors,
  links, repeats; compared by their reprs), or the same refusal (a
  config with no plannable block);
* ``strip_collectives`` and ``map_cuts`` of every cut of the stripped
  chain;
* ``plan_chain`` of the captured graph and ``plan_collective_blind``:
  the same cuts, schedule, traffic, modeled seconds and per-segment
  tiles, or the same ``InfeasibleError``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.core.ftl import partition as jpartition  # noqa: E402
from repro.distributed import mesh_capture as JMC  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import partition as tpartition  # noqa: E402
from repro_torch.distributed import mesh_capture as TMC  # noqa: E402

MESH_SIZES = (1, 2, 4, 8, 16)
M = 32


def _chain_key(chain):
    return (chain.cuts(), chain.schedule, chain.traffic_bytes,
            chain.modeled_runtime_s, chain.per_level_traffic,
            [(s.lo, s.hi, dict(s.plan.tiles), s.plan.traffic_bytes,
              s.plan.modeled_runtime_s) for s in chain.segments])


def _run(fn, *args, **kw):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kw), None
    except Exception as e:          # the refusals are compared too
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("target", ["tpu_v5e", "rv32_mesh"])
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_capture_strip_and_plans_match_reference(arch, target):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jt, tt = jhw.get_target(target), thw.get_target(target)
    planned = 0
    seen = set()
    for n in MESH_SIZES:
        js, ts = JMC.shard_spec(jcfg, n), TMC.shard_spec(tcfg, n)
        assert (ts.mesh_size, ts.heads, ts.d_ff, ts.any) == \
            (js.mesh_size, js.heads, js.d_ff, js.any)
        jg, jerr = _run(JMC.capture_block, jcfg, m=M, mesh_size=n)
        tg, terr = _run(TMC.capture_block, tcfg, m=M, mesh_size=n)
        assert terr == jerr, (n, terr, jerr)
        if jg is None:
            continue
        assert repr(tg) == repr(jg), n
        jst, tst = JMC.strip_collectives(jg), TMC.strip_collectives(tg)
        assert repr(tst) == repr(jst), n
        assert (tst is tg) == (jst is jg)
        cuts = jpartition.all_cuts(jst)
        assert tpartition.all_cuts(tst) == cuts
        assert TMC.map_cuts(tg, tst, cuts) == JMC.map_cuts(jg, jst, cuts)
        if repr(jg) in seen:        # a size that shards nothing: the same
            continue                # graph, planned at a smaller size
        seen.add(repr(jg))
        # with no collective to strip, the blind plan is plan_chain's
        for plan in ("plan_chain",) if jst is jg else ("plan_chain",
                                                       "blind"):
            if plan == "plan_chain":
                jp, jperr = _run(jpartition.plan_chain, jg, target=jt)
                tp, tperr = _run(tpartition.plan_chain, tg, target=tt)
            else:
                jp, jperr = _run(JMC.plan_collective_blind, jg, target=jt)
                tp, tperr = _run(TMC.plan_collective_blind, tg, target=tt)
            assert tperr == jperr, (n, plan, tperr, jperr)
            if jp is not None:
                assert _chain_key(tp) == _chain_key(jp), (n, plan)
                planned += 1
    if arch != "xlstm-1.3b":        # the one config with no block
        assert planned > 0
