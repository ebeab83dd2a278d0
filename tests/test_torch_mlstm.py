"""The port's mLSTM scan and xLSTM blocks against the JAX package's, on the
CPU.

Same numpy-seeded inputs, fp32: the plain scan against the reference's
plain scan (any T) and its Pallas kernel in interpret mode (T a multiple
of its ``block_t``), with and without the final state; padded steps
(gates ``-inf``/``+inf``) carry the state exactly; ``mlstm_block``,
``slstm_block`` and both decode steps on converted weights.  Tolerance:
rtol = atol = 1e-4, the JAX kernel test's (``tests/test_kernels.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm import mlstm_scan as jkernel  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import mlstm, ops, ref as tref  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _scan_inputs(b, h, t, dh, seed=0):
    """q, k, v at 0.3 and the gates at unit scale, the forget gate
    shifted by 3 as the model shifts it (the JAX kernel test's draw)."""
    rng = np.random.default_rng(seed)
    q, k, v = ((0.3 * rng.standard_normal((b, h, t, dh))).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((b, h, t)).astype(np.float32)
    f_pre = (rng.standard_normal((b, h, t)) + 3.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _both(args):
    return ([torch.from_numpy(a) for a in args],
            [jnp.asarray(a) for a in args])


@pytest.mark.parametrize("b,h,t,dh,block_t", [
    (1, 2, 128, 64, 64),
    (1, 2, 128, 64, 128),
    (2, 1, 256, 32, 128),
])
def test_mlstm_scan_matches_reference_plain_and_pallas(b, h, t, dh, block_t):
    targs, jargs = _both(_scan_inputs(b, h, t, dh))
    got = tref.mlstm_scan(*targs)
    assert got.dtype == torch.float32 and got.shape == (b, h, t, dh)
    _close(got, jref.mlstm_scan(*jargs))
    _close(got, jkernel(*jargs, block_t=block_t, interpret=True))


@pytest.mark.parametrize("t", [1, 37, 200])
def test_mlstm_scan_any_length_and_state_match_reference(t):
    """T not a multiple of 128 (the Pallas kernel's default block): h and
    the final (C, n, m) against the reference's plain scan."""
    targs, jargs = _both(_scan_inputs(2, 2, t, 48, seed=t))
    got, st = tref.mlstm_scan(*targs, return_state=True)
    want, jst = jref.mlstm_scan(*jargs, return_state=True)
    _close(got, want)
    assert set(st) == {"C", "n", "m"}
    for name in st:
        assert st[name].dtype == torch.float32
        assert tuple(st[name].shape) == jst[name].shape
        _close(st[name], jst[name])


def test_padded_steps_carry_the_state_exactly():
    """Gates i = -inf, f = +inf after ``n`` steps give i' = 0, f' = 1:
    the state equals the unpadded scan's, bit for bit, and the
    reference's within tolerance."""
    q, k, v, i_pre, f_pre = _scan_inputs(1, 2, 40, 32, seed=5)
    n = 23
    i_pad, f_pad = i_pre.copy(), f_pre.copy()
    i_pad[..., n:] = -np.inf
    f_pad[..., n:] = np.inf
    padded, _ = _both((q, k, v, i_pad, f_pad))
    out, st = tref.mlstm_scan(*padded, return_state=True)
    cut, jcut = _both([a[:, :, :n] for a in (q, k, v, i_pre, f_pre)])
    out_n, st_n = tref.mlstm_scan(*cut, return_state=True)
    for name in st:
        assert torch.equal(st[name], st_n[name])
    assert torch.equal(out[:, :, :n], out_n)
    assert bool(torch.isfinite(out).all())
    _, jst = jref.mlstm_scan(*jcut, return_state=True)
    for name in st:
        _close(st[name], jst[name])


def test_ops_mlstm_dispatch_on_cpu_tensors():
    """A CPU tensor runs the plain scan through ``ops`` and the wrapper
    alike, launching nothing; bf16 inputs give bf16 h and fp32 state;
    ``ops.mlstm`` takes the reference's ``backend``: ``'ref'`` gives the
    same h, and a name it does not know raises."""
    targs, _ = _both(_scan_inputs(1, 2, 9, 32, seed=7))
    bf = [a.to(torch.bfloat16) for a in targs[:3]] + targs[3:]
    before = mlstm.launches
    h, st = ops.mlstm(*bf, return_state=True)
    hr, str_ = tref.mlstm_scan(*bf, return_state=True)
    assert torch.equal(h, hr) and h.dtype == torch.bfloat16
    assert all(torch.equal(st[n], str_[n]) and st[n].dtype == torch.float32
               for n in st)
    assert torch.equal(ops.mlstm(*bf), hr)
    assert torch.equal(mlstm.mlstm_scan(*bf), hr)
    assert mlstm.launches == before
    assert torch.equal(ops.mlstm(*bf, backend="ref"), hr)
    with pytest.raises(ValueError):
        ops.mlstm(*bf, backend="pallas")


# ---------------------------------------------------------------------------
# the blocks, on converted weights
# ---------------------------------------------------------------------------

def _cfgs(**over):
    return (dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                                remat=False, **over),
            dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                                remat=False, **over))


@pytest.fixture(scope="module")
def blocks():
    jcfg, tcfg = _cfgs()
    jm = JR.init_mlstm_block(jcfg, jax.random.PRNGKey(1))
    js = JR.init_slstm_block(jcfg, jax.random.PRNGKey(2))
    tm, ts = (params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
              for p in (jm, js))
    return jcfg, tcfg, {"mlstm": (jm, tm), "slstm": (js, ts)}


_BLOCK = {"mlstm": (JR.mlstm_block, TR.mlstm_block, JR.mlstm_block_decode,
                    TR.mlstm_block_decode),
          "slstm": (JR.slstm_block, TR.slstm_block, JR.slstm_block_decode,
                    TR.slstm_block_decode)}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_param_dtypes_follow_the_reference(blocks):
    """``wi``, ``wf`` and the sLSTM's ``r*`` stay fp32 beside bf16
    weights, as in the reference."""
    jcfg, tcfg, _ = blocks
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    for kind, init in (("mlstm", TR.init_mlstm_block),
                       ("slstm", TR.init_slstm_block)):
        jinit = getattr(JR, f"init_{kind}_block")
        jp = jax.tree.map(np.asarray, jinit(jcfg16, jax.random.PRNGKey(0)))
        tp = init(tcfg, torch.Generator().manual_seed(0), torch.bfloat16,
                  torch.device("cpu"))

        def spec(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update({f"{k}.{kk}": vv for kk, vv in
                                spec(v).items()})
                else:
                    out[k] = (tuple(v.shape),
                              str(v.dtype).removeprefix("torch."))
            return out

        assert spec(tp) == spec(jp)
    assert spec(tp)["rz"][1] == "float32"


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_state_and_decode_match_reference(blocks, kind):
    jcfg, tcfg, ps = blocks
    jp, tp = ps[kind]
    jblock, tblock, jdec, tdec = _BLOCK[kind]
    x = _x(2, 12, jcfg.d_model, 3)
    jy, jst = jblock(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, tst = tblock(tcfg, tp, torch.from_numpy(x), return_state=True)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for name in tst:
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name])
    _close(tblock(tcfg, tp, torch.from_numpy(x)), jy)
    for i in range(3):
        x1 = _x(2, 1, jcfg.d_model, 10 + i)
        jy1, jst = jdec(jcfg, jp, jnp.asarray(x1), jst)
        ty1, tst2 = tdec(tcfg, tp, torch.from_numpy(x1), tst)
        assert tst2 is tst              # updated in place
        _close(ty1, jy1)
        for name in tst:
            _close(tst[name], jst[name])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_state_at_length_equals_unpadded(blocks, kind):
    """The state of a right-padded sequence taken at ``length`` equals the
    reference's state of the unpadded sequence, and the real positions'
    outputs are the unpadded ones."""
    jcfg, tcfg, ps = blocks
    jp, tp = ps[kind]
    jblock, tblock, _, _ = _BLOCK[kind]
    x = _x(1, 16, jcfg.d_model, 4)
    for n in (1, 7, 16):
        jy, jst = jblock(jcfg, jp, jnp.asarray(x[:, :n]), return_state=True)
        ty, tst = tblock(tcfg, tp, torch.from_numpy(x), return_state=True,
                         length=n)
        for name in tst:
            _close(tst[name], jst[name])
        _close(ty[:, :n], jy)


def test_mlstm_chunked_remat_is_refused_for_the_stateless_scan(blocks):
    """``mlstm_chunk > 0`` is the reference's training-time remat scan.
    The port runs it too (the name is kept from when it refused it): the
    stateless block matches the reference's chunked scan, output and the
    gradients of x and every weight, at a T that is not a multiple of
    the chunk (the reference halves it to 4); the prefill with state,
    which the reference runs unchunked, still matches."""
    jcfg, tcfg, ps = blocks
    jp, tp = ps["mlstm"]
    jcfg8 = dataclasses.replace(jcfg, mlstm_chunk=8)
    tcfg8 = dataclasses.replace(tcfg, mlstm_chunk=8)
    x = _x(1, 12, jcfg.d_model, 6)
    cot = _x(1, 12, jcfg.d_model, 7)
    leaves = TR_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = TR.mlstm_block(tcfg8, tp, xt)
    tg = torch.autograd.grad(ty, [xt, *leaves.values()],
                             torch.from_numpy(cot))

    def f(p, xx):
        return jnp.sum(JR.mlstm_block(jcfg8, p, xx) * cot)

    jy = JR.mlstm_block(jcfg8, jp, jnp.asarray(x))
    jgp, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    _close(ty.detach(), jy)
    _close(tg[0], jgx)
    jflat = dict(_leaves(jgp))
    for (name, _), g in zip(leaves.items(), tg[1:]):
        _close(g, jflat[name], rtol=1e-4, atol=1e-4 * float(
            np.abs(np.asarray(jflat[name])).max()) + 1e-6)
    for t in leaves.values():
        t.requires_grad_(False)
    with torch.no_grad():
        ty, _ = TR.mlstm_block(tcfg8, tp, torch.from_numpy(x),
                               return_state=True)
    jy, _ = JR.mlstm_block(jcfg8, jp, jnp.asarray(x), return_state=True)
    _close(ty, jy)


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + "/")
        else:
            yield pre + k, v


def TR_leaves(tree) -> dict:
    return dict(_leaves(tree))