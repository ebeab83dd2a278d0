"""How a small difference grows through xLSTM's random-weight stack, in
the JAX reference and in the port, on the same weights, layer by layer.

Each layer's weights are drawn by the reference's ``_init_layer`` (its
scales, ``down`` at 1/sqrt(2 n_layers) of the config's depth), run
through both models, and dropped before the next layer's: the stack is
never held whole.  Per layer it records, on one (1, s + n) input drawn
like an embedding row (N(0, 1/d)):

* ``jax_growth`` / ``port_growth``: max |x - x'| of the stateless forward
  after the input x' = x + eps * N(0, 1/d), in each model: how far the
  stack carries a difference in its input;
* ``jax_fwd_dec`` / ``port_fwd_dec``: max |x - y| over the last n + 1
  tokens between the stateless forward x and the serving path y (the
  block with state over the first s tokens, then n decode steps), in
  each model: the forward-against-decode difference layer by layer;
* ``port_vs_jax``: max |y_port - y_jax|, the two serving paths against
  each other, each carrying its own stream;
* ``port_vs_jax_layer``: the same for this layer alone, the port's
  serving path fed the reference's input (teacher-forced);
* ``scale``: max |x| of the reference's forward.

In fp32 the forward and the serving path round differently (a scan
against single steps), so ``*_fwd_dec`` shows how the stack carries that
rounding.  At xlstm-1.3b's full width (d 2048, mLSTM head dim 1024,
48 layers), on the CPU, one layer's weights at a time::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_xlstm_growth.py

(``--dtype bfloat16`` as served; ``--reduced`` runs the reduced config
with ``slstm_every=2``.)  The tests run the same walk on the reduced
config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "xlstm-1.3b"
KEYS = ("jax_growth", "port_growth", "jax_fwd_dec", "port_fwd_dec",
        "port_vs_jax", "port_vs_jax_layer", "scale")


def configs(reduced: bool, dtype: str = "float32"):
    """The (JAX, port) configs of xlstm-1.3b, full width or reduced with
    an sLSTM every second layer."""
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_config(ARCH)
        if reduced:
            cfg = dataclasses.replace(cfg.reduced(), slstm_every=2)
        out.append(dataclasses.replace(cfg, dtype=dtype, remat=False))
    return out


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a, np.float64)


def _maxabs(a, b) -> float:
    return float(np.abs(_f64(a) - _f64(b)).max())


class _Jax:
    """The reference's layer functions, jitted once per kind."""

    def __init__(self, cfg, s: int):
        pos = jnp.arange(s)
        self.apply = {}
        self.prefill = {}
        self.decode = {}
        for kind in set(JM.period_kinds(cfg)):
            self.apply[kind] = jax.jit(
                lambda p, x, kind=kind: JM._apply_layer(
                    cfg, p, kind, x, positions=jnp.arange(x.shape[1]),
                    ctx=None)[0])
            self.prefill[kind] = jax.jit(
                lambda p, x, kind=kind: JM._layer_prefill(
                    cfg, p, kind, x, positions=pos, ctx=None))
            self.decode[kind] = jax.jit(
                lambda p, x, c, kind=kind: JM._layer_decode(
                    cfg, p, kind, x, c, jnp.int32(0)))

    def serve(self, p, kind: str, y, s: int):
        """One layer's serving path on ``y`` (1, t, d): the block with
        state on the first s tokens, then one decode step a token."""
        out, c = self.prefill[kind](p, y[:, :s])
        steps = [out]
        for j in range(s, y.shape[1]):
            o, c = self.decode[kind](p, y[:, j:j + 1], c)
            steps.append(o)
        return jnp.concatenate(steps, 1)


def _port_serve(cfg, p, kind: str, y: torch.Tensor, s: int) -> torch.Tensor:
    """The port's ``_Jax.serve``."""
    pos = torch.arange(y.shape[1])
    out, c = TM._layer_prefill(cfg, p, kind, y[:, :s], positions=pos[:s])
    steps = [out]
    for j in range(s, y.shape[1]):
        o, c = TM._layer_decode(cfg, p, kind, y[:, j:j + 1], c, pos[j])
        steps.append(o)
    return torch.cat(steps, 1)


@torch.no_grad()
def walk(reduced: bool = False, s: int = 32, n_dec: int = 4,
         eps: float = 1e-4, seed: int = 0, dtype: str = "float32"):
    """The per-layer record (dict of lists, ``KEYS``) of the module
    docstring, and the layer kinds."""
    jcfg, tcfg = configs(reduced, dtype)
    per = JM.period_kinds(jcfg)
    kinds = [per[i % len(per)] for i in range(jcfg.n_layers)]
    d, t = jcfg.d_model, s + n_dec
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((1, t, d)) * d ** -0.5
    dx = eps * rng.standard_normal((1, t, d)) * d ** -0.5
    jx = _Jax(jcfg, s)
    tpos = torch.arange(t)
    # forward, perturbed forward, serving path: JAX arrays and tensors
    ja, jb, jy = (jnp.asarray(a, jcfg.dtype) for a in (x0, x0 + dx, x0))
    ta, tb, ty = (params_from_numpy({"x": np.asarray(a)}, "cpu")["x"]
                  for a in (ja, jb, jy))
    key = jax.random.PRNGKey(seed)
    rec = {k: [] for k in KEYS}
    for i, kind in enumerate(kinds):
        jp = JM._strip_kind(JM._init_layer(jcfg, jax.random.fold_in(key, i),
                                           kind))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        ja, jb = jx.apply[kind](jp, ja), jx.apply[kind](jp, jb)
        ta, _ = TM._apply_layer(tcfg, tp, kind, ta, positions=tpos)
        tb, _ = TM._apply_layer(tcfg, tp, kind, tb, positions=tpos)
        forced = _port_serve(tcfg, tp, kind,
                             params_from_numpy({"y": np.asarray(jy)},
                                               "cpu")["y"], s)
        jy = jx.serve(jp, kind, jy, s)
        ty = _port_serve(tcfg, tp, kind, ty, s)
        tail = slice(s - 1, t)
        rec["jax_growth"].append(_maxabs(ja, jb))
        rec["port_growth"].append(_maxabs(ta, tb))
        rec["jax_fwd_dec"].append(_maxabs(ja[:, tail], jy[:, tail]))
        rec["port_fwd_dec"].append(_maxabs(ta[:, tail], ty[:, tail]))
        rec["port_vs_jax"].append(_maxabs(ty, jy))
        rec["port_vs_jax_layer"].append(_maxabs(forced, jy))
        rec["scale"].append(float(jnp.abs(ja).max()))
        del jp, tp
    return rec, kinds


def per_layer_factor(d: list[float]) -> float | None:
    """The geometric mean growth a layer of a per-layer difference, from
    its first non-zero layer to the last (None: fewer than two)."""
    first = next((i for i, v in enumerate(d) if v > 0), len(d))
    if first >= len(d) - 1:
        return None
    return (d[-1] / d[first]) ** (1.0 / (len(d) - 1 - first))


# ---------------------------------------------------------------------------
# tests: the reduced config (d 64, an sLSTM every second layer)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_walk():
    return walk(reduced=True, s=12, n_dec=3, eps=1e-3)


def test_the_port_carries_a_difference_as_the_reference_does(reduced_walk):
    """The same weights and the same input difference: each layer's
    max |x - x'| in the port within 1% of the reference's (the difference
    is 1e-3 of the input, far above fp32's rounding)."""
    rec, _ = reduced_walk
    np.testing.assert_allclose(rec["port_growth"], rec["jax_growth"],
                               rtol=1e-2)
    assert min(rec["jax_growth"]) > 0.0


def test_the_serving_path_matches_the_reference_layer_by_layer(reduced_walk):
    """Through every layer, the port's block-with-state + decode stream
    equals the reference's within 1e-4 (fp32, as ``test_torch_xlstm``),
    and in each model the forward and the serving path agree within
    1e-4 of the stream's scale."""
    rec, kinds = reduced_walk
    assert set(kinds) == {"mlstm", "slstm"}
    assert max(rec["port_vs_jax"]) <= 1e-4
    assert max(rec["port_vs_jax_layer"]) <= 1e-4
    for name in ("jax_fwd_dec", "port_fwd_dec"):
        for d, sc in zip(rec[name], rec["scale"]):
            assert d <= 1e-4 * max(sc, 1.0), (name, rec[name])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    help="the weights' and the stream's (bfloat16: as "
                         "served)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rec, kinds = walk(args.reduced, dtype=args.dtype)
    print("layer kind " + " ".join(f"{k:>12}" for k in KEYS))
    for i, kind in enumerate(kinds):
        print(f"{i:5d} {kind:5s}"
              + " ".join(f"{rec[k][i]:12.4g}" for k in KEYS))
    summary = {k: per_layer_factor(rec[k]) for k in
               ("jax_growth", "port_growth", "jax_fwd_dec", "port_fwd_dec")}
    print(json.dumps({"per_layer_factor": summary, "layers": len(kinds),
                      "dtype": args.dtype,
                      "seconds": time.perf_counter() - t0, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
