"""The mLSTM scan's gradient in the port against the JAX package's, on the
CPU.

* ``ref.mlstm_scan_chunked`` (the reference's time-chunked remat scan)
  against the reference's: h, the final state and ``jax.grad`` of all
  five inputs, with T a multiple of the chunk and not (both halve the
  chunk until it divides T); rtol = atol = 1e-4 in fp32.
* ``ref.mlstm_bwd`` (autograd through the plain scan, in checkpointed
  chunks) against ``jax.grad`` of ``repro.kernels.ref.mlstm_scan``, and
  the identities that let the kernel compute the gates' gradients from
  row dots with m held constant: ``di = k·dk`` and ``d log σ(f)`` the
  reverse cumulative sum of ``q·dq − k·dk``.
* ``mlstm.chunkwise_bwd_model`` (the backward kernel's decomposition and
  rounding points) against ``jax.grad`` on bf16 q, k, v and dh: dq, dk,
  dv within 0.02 + 0.02·|g| (bf16 outputs, phase 2's rule on the card)
  and di, df within 1e-3·max|g| + 1e-3·|g| (fp32: the row dots and the
  cumulative sum in another order than autodiff's).  Rounded once to
  bf16 instead of split into hi/lo pairs, the gates miss it.
* ``mlstm.bwd_schedule``: footprints, grids, scratch and refusals; one
  chunk keeps no end-gradient, and dropping the last chunk's (zero)
  changes no bit of dK; the state pass and the gradient kernel's source
  holds no ``mma.sync`` path.
* The Function on CPU tensors runs the plain gradient; ``mlstm_block``
  with ``mlstm_chunk > 0`` and a reduced xlstm-1.3b train step with it
  against the reference's.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train import steps as JS  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import mlstm, ops, ref as tref  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = (2e-2, 2e-2)          # (atol, rtol) of a bf16 gradient
GATE_TOL = (1e-3, 1e-3)          # (share of max|g|, rtol) of di and df
NAMES = ("q", "k", "v", "i", "f")


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(b, h, t, dh, seed, *, scale=1.0, i_scale=1.0, f_shift=3.0):
    rng = np.random.default_rng(seed)
    q, k, v, cot = ((scale * rng.standard_normal((b, h, t, dh))
                     ).astype(np.float32) for _ in range(4))
    i_pre = (i_scale * rng.standard_normal((b, h, t))).astype(np.float32)
    f_pre = (rng.standard_normal((b, h, t)) + f_shift).astype(np.float32)
    return [q, k, v, i_pre, f_pre], cot


def _jgrads(fn, args, cot):
    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * cot)
    return jax.grad(loss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in args])


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _share(got, want, tol) -> float:
    """Largest share of atol + rtol·|want| that |got − want| uses."""
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    return float((np.abs(g - w) / (tol[0] + tol[1] * np.abs(w))).max())


def _gate_tol(want) -> tuple[float, float]:
    return (GATE_TOL[0] * float(np.abs(np.asarray(want)).max()),
            GATE_TOL[1])


# ---------------------------------------------------------------------------
# the chunked plain scan and the plain gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(32, 8), (24, 16), (37, 16), (40, 64)])
def test_chunked_scan_matches_the_reference(t, chunk):
    args, cot = _inputs(1, 2, t, 16, seed=t + chunk, scale=0.3)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    th, tst = tref.mlstm_scan_chunked(*targs, chunk=chunk, return_state=True)
    jh, jst = jref.mlstm_scan_chunked(*[jnp.asarray(a) for a in args],
                                      chunk=chunk, return_state=True)
    _close(th, jh)
    for n in ("C", "n", "m"):
        _close(tst[n], jst[n])
    tg = torch.autograd.grad(th, targs, torch.from_numpy(cot))
    jg = _jgrads(lambda *a: jref.mlstm_scan_chunked(*a, chunk=chunk), args,
                 cot)
    for g, w in zip(tg, jg):
        _close(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("t", [8, 37, 64])
def test_chunked_scan_is_the_plain_scan_bit_for_bit(t):
    args, _ = _inputs(2, 1, t, 32, seed=t)
    targs = [torch.from_numpy(a).to(torch.bfloat16) if i < 3 else
             torch.from_numpy(a) for i, a in enumerate(args)]
    h, st = tref.mlstm_scan_chunked(*targs, chunk=16, return_state=True)
    hr, str_ = tref.mlstm_scan(*targs, return_state=True)
    assert torch.equal(h, hr)
    assert all(torch.equal(st[n], str_[n]) for n in st)


@pytest.mark.parametrize("b,h,t,dh", [(1, 2, 70, 16), (2, 1, 33, 32)])
def test_plain_gradient_matches_jax_grad(b, h, t, dh):
    args, cot = _inputs(b, h, t, dh, seed=dh + t, scale=0.5)
    tg = tref.mlstm_bwd(*[torch.from_numpy(a) for a in args],
                        torch.from_numpy(cot))
    jg = _jgrads(jref.mlstm_scan, args, cot)
    for g, w in zip(tg, jg):
        assert g.dtype == torch.float32
        _close(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("seed,i_scale,f_shift", [(0, 1.0, 3.0),
                                                  (1, 3.0, 0.0)])
def test_plain_gradient_satisfies_the_m_frozen_identities(seed, i_scale,
                                                          f_shift):
    """With m held constant (exact: h does not depend on m) the gates'
    gradients are row dots of dq and dk: di_s = k_s·dk_s, and d log σ(f)
    is the reverse cumulative sum of q_t·dq_t − k_t·dk_t.  The plain
    scan runs in fp32, so both hold to fp32 rounding: 1e-5 of the
    largest gradient."""
    args, cot = _inputs(1, 2, 48, 16, seed=seed, scale=0.5,
                        i_scale=i_scale, f_shift=f_shift)
    q, k, v, i_pre, f_pre = (torch.from_numpy(a) for a in args)
    dq, dk, dv, di, df = tref.mlstm_bwd(q, k, v, i_pre, f_pre,
                                        torch.from_numpy(cot))
    q, k, dq, dk = (x.double() for x in (q, k, dq, dk))
    kd = (k * dk).sum(-1)
    dlf = torch.flip(torch.cumsum(torch.flip((q * dq).sum(-1) - kd, [-1]),
                                  -1), [-1])
    assert float((di - kd).abs().max()) <= 1e-5 * float(di.abs().max())
    assert float((df - dlf * torch.sigmoid(-f_pre.double())).abs().max()) \
        <= 1e-5 * float(df.abs().max())


@pytest.mark.parametrize("seed,i_scale,f_shift", [(0, 1.0, 3.0),
                                                  (1, 3.0, 0.0)])
def test_plain_gradient_takes_the_given_branches(seed, i_scale, f_shift):
    """``branch`` sets each step's side of the denominator's max: at the
    sides the chunkwise forward saves (``den[..., 1]``, as the kernel's
    training build does), which are the plain scan's own away from a tie,
    the gradient is the one taken without it, bit for bit; with one
    step's side turned to the floor, dq changes at that step."""
    args, cot = _inputs(1, 2, 80, 16, seed=seed, scale=0.5,
                        i_scale=i_scale, f_shift=f_shift)
    targs = [torch.from_numpy(a) for a in args]
    dh = torch.from_numpy(cot)
    _, saved = mlstm.chunkwise_model(*targs, saved=True)
    branch = saved["den"][..., 1]
    assert set(branch.unique().tolist()) <= {-1.0, 0.0, 1.0}
    want = tref.mlstm_bwd(*targs, dh)
    got = tref.mlstm_bwd(*targs, dh, branch=branch)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    b_, h_, t_ = (branch != 0).nonzero()[-1].tolist()
    flipped = branch.clone()
    flipped[b_, h_, t_] = 0.0
    dq = tref.mlstm_bwd(*targs, dh, branch=flipped)[0]
    assert not torch.allclose(dq[b_, h_, t_], want[0][b_, h_, t_])


# ---------------------------------------------------------------------------
# the backward kernel's arithmetic
# ---------------------------------------------------------------------------

def _bf16_case(b, h, t, dh, seed, **kw):
    args, cot = _inputs(b, h, t, dh, seed, **kw)
    targs = [torch.from_numpy(a).to(torch.bfloat16) if i < 3 else
             torch.from_numpy(a) for i, a in enumerate(args)]
    tcot = torch.from_numpy(cot).to(torch.bfloat16)
    # the JAX side gets the same bf16 values, in fp32
    jargs = [x.float().numpy() for x in targs]
    return targs, tcot, jargs, tcot.float().numpy()


# (b, h, t, dh, seed, input draw): L = 64 with T below, at and off a
# multiple of it, head dims 32, 64, 96 and 128, and gates far from the
# model's (f unshifted, i at scale 3) that move the stabiliser often
MODEL_CASES = [
    (1, 2, 150, 96, 1, {}),
    (1, 1, 128, 64, 2, {}),
    (1, 2, 37, 32, 3, {}),
    (2, 1, 100, 128, 4, {"f_shift": 0.0, "i_scale": 3.0}),
]


@pytest.mark.parametrize("b,h,t,dh,seed,kw", MODEL_CASES)
def test_bwd_model_matches_jax_grad(b, h, t, dh, seed, kw):
    targs, tcot, jargs, jcot = _bf16_case(b, h, t, dh, seed, **kw)
    got = mlstm.chunkwise_bwd_model(*targs, tcot)
    want = _jgrads(jref.mlstm_scan, jargs, jcot)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.bfloat16 if n in "qkv" else torch.float32)
        tol = BF16_TOL if n in "qkv" else _gate_tol(w)
        assert _share(g, w, tol) <= 1.0, n


def test_the_floor_wins_on_some_steps_and_not_on_others():
    """The cases above take both branches of the denominator: where
    |n·q̃| wins (its sign flows back) and where the floor exp(−m) does
    (nothing flows through n)."""
    for b, h, t, dh, seed, kw in MODEL_CASES:
        targs, _, _, _ = _bf16_case(b, h, t, dh, seed, **kw)
        _, kept = mlstm.chunkwise_model(*targs, saved=True)
        floor = float((kept["den"][..., 1] == 0).float().mean())
        assert 0.02 < floor < 0.98, (t, dh, floor)
        assert set(kept["den"][..., 1].unique().tolist()) == {-1.0, 0.0, 1.0}


def test_unsplit_operands_miss_the_gate_tolerance():
    """Why the backward feeds its fp32 operands as bf16 pairs too: rounded
    once to bf16, di and df leave 1e-3·max|g| + 1e-3·|g|, while the pairs
    stay far inside it on the same input."""
    targs, tcot, jargs, jcot = _bf16_case(1, 1, 128, 64, 2)
    want = _jgrads(jref.mlstm_scan, jargs, jcot)
    pair = mlstm.chunkwise_bwd_model(*targs, tcot)
    once = mlstm.chunkwise_bwd_model(*targs, tcot, split=False)
    for j in (3, 4):
        tol = _gate_tol(want[j])
        assert _share(pair[j], want[j], tol) < 0.1
        assert _share(once[j], want[j], tol) > 2.0


def test_saved_tensors_are_the_forward_s_own():
    """What the training build saves, in the model: the state at each
    chunk's start is the final state of the scan cut there, bit for bit
    (zero at the first), h rounds to the returned h, and den is
    max(|n·q̃|, exp(−m)) with the sign's flag 0 exactly where the floor
    won."""
    targs, _, _, _ = _bf16_case(1, 2, 150, 32, 7)
    h, kept = mlstm.chunkwise_model(*targs, saved=True)
    assert tuple(kept["states"].shape) == mlstm.saved_shapes(1, 2, 150,
                                                             32)["states"]
    assert not kept["states"][:, :, 0].any()
    for c in (1, 2):
        cut = [x[:, :, :64 * c].contiguous() for x in targs]
        _, st = mlstm.chunkwise_model(*cut, return_state=True)
        assert torch.equal(kept["states"][:, :, c, :32], st["C"])
        assert torch.equal(kept["states"][:, :, c, 32], st["n"])
        assert torch.equal(kept["m0"][..., c], st["m"])
    assert torch.equal(kept["hf"].to(torch.bfloat16), h)
    assert bool((kept["den"][..., 0] > 0).all())


# ---------------------------------------------------------------------------
# the backward's schedule
# ---------------------------------------------------------------------------

HEAD_DIMS = list(range(32, mlstm.MAX_HEAD_DIM + 1, 32))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_bwd_footprints_fit_a_block(dh):
    """Every kernel fits a block at every head dim; the state pass's
    footprint is the same at each: 1 KB of slack, one ring stage an owner
    (four) of Q_j, K_j and G_j's pair (2·8 KB + 2·4 KB), two 36 KB chunk
    buffers, 256 B of mbarriers (eight stages, two an owner, do not fit);
    the gradient block's is small enough for two a streaming
    multiprocessor."""
    s = mlstm.bwd_schedule(1, 4, 512, dh)
    for n in (s.prep_smem_bytes, s.state_smem_bytes, s.grad_smem_bytes):
        assert n <= mlstm.SMEM_LIMIT
    assert s.state_stages == mlstm.OWNERS == 4
    assert s.state_smem_bytes == 1024 + 4 * 24_576 + 2 * 36_864 + 256
    assert mlstm.bwd_state_smem_bytes(8) > mlstm.SMEM_LIMIT
    assert 2 * (s.grad_smem_bytes + 1024) <= 233_472
    assert s.col_tiles == -(-dh // 64)
    assert s.state_grid == (dh // 32, 4)


def test_bwd_schedule_at_the_train_shape():
    """(4, 4, 512, 1024): 8 chunks of 64; 32 state-pass blocks a head
    (32 columns of dv each), 4 ring stages; 16 column tiles x 2 outputs
    (dQ, dK); the end-gradients of 7 of the 8 chunks (0.47 GB; the
    last chunk's is zero and not stored)."""
    s = mlstm.bwd_schedule(4, 4, 512, 1024)
    assert (s.chunk, s.n_chunks, s.col_tiles) == (64, 8, 16)
    assert s.state_stages == 4
    assert s.prep_grid == (8, 16) and s.state_grid == (32, 16)
    assert s.grad_grid == (32, 8, 16) and s.gate_grid == 16
    states = mlstm.saved_shapes(4, 4, 512, 1024)["states"]
    assert s.grad_state_bytes == 4 * int(np.prod(states)) * 7 // 8 \
        == 470_220_800
    assert s.chunk_bytes == 4 * 16 * 8 * (2 * 64 * 64 + 4 * 64)
    assert s.dots_bytes == 4 * 16 * 2 * 16 * 512
    assert s.label == ("L=64, prep 8x16, state 32x16 (4 stages), grad "
                       "32x8x16, gates 16")


@pytest.mark.parametrize("t", [1, 37, 64])
def test_bwd_schedule_of_one_chunk_keeps_no_end_gradient(t):
    """T <= 64 is one chunk: its end-gradient is zero, so the state pass
    stores none and dK reads none (``grad_state_bytes`` 0); the scratch
    is the chunk's two L x L matrices, its weights and the row dots."""
    s = mlstm.bwd_schedule(2, 3, t, 96)
    assert s.n_chunks == 1 and s.grad_state_bytes == 0
    assert s.grad_grid == (4, 1, 6)
    assert s.scratch_bytes == 4 * 6 * (2 * 64 * 64 + 4 * 64) \
        + 4 * 6 * 2 * 2 * t


@pytest.mark.parametrize("t", [150, 64 * 3])
def test_dropping_the_last_chunk_s_end_gradient_changes_no_bit(t):
    """The last chunk's end-gradient is zero: dK there computed with it
    (``w∘(V·0) + w ⊗ 0 + dSᵀ Q``) and without it (``dSᵀ Q`` alone, as the
    gradient kernel runs it) are the same bits, ragged T or not, and the
    model's dK over the last chunk is the latter."""
    targs, tcot, _, _ = _bf16_case(1, 2, t, 32, 11)
    per = mlstm._bwd_chunks(*targs, tcot, 64, True)
    z = per[-1]
    zero = torch.zeros(1, 2, 33, 32)
    without = mlstm._grad_k(z, None, True)
    assert torch.equal(mlstm._grad_k(z, zero, True), without)
    assert without.abs().max() > 0
    got = mlstm.chunkwise_bwd_model(*targs, tcot)[1]
    last = 64 * (len(per) - 1)
    assert torch.equal(got[:, :, last:],
                       without[:, :, :t - last].to(torch.bfloat16))


def test_state_pass_and_gradients_run_on_tma_and_wgmma():
    """The state pass and the gradient kernel hold no warp-level
    mma.sync, ldmatrix or cp.async path: their products are wgmma on
    TMA-loaded tiles (only the prep kernel, about 5% of the call, stays
    on mma.sync).  The state pass writes dV; the gradient kernel has two
    roles."""
    from pathlib import Path
    src = (Path(mlstm.__file__).resolve().parent.parent / "csrc"
           / "mlstm_bwd.cu").read_text()
    start = src.index("mlstm_bwd_state_kernel(const")
    end = src.index("mlstm_bwd_gate_kernel(const")
    body = src[start:end]
    for old in ("mma16816", "ldmatrix", "load_a(", "load_b_", "cp_async"):
        assert old not in body, old
    for part in ("tma_load_3d", "mbar_wait", "wgmma_n32<1>", "wgmma_n32_rs",
                 "Wgmma<64, 0>::rs", "wgmma_n64_tss", "tma_store_3d",
                 "p.dv +", "grad_block<0>", "grad_block<1>"):
        assert part in body, part
    assert "grad_block<2>" not in body
    assert "mma16816" in src[:start]


@pytest.mark.parametrize("b,h,t,dh", [
    (1, 4, 64, 48), (1, 4, 64, 1056), (0, 4, 64, 128), (1, 4, 0, 128),
    (65536, 1, 64, 128)])
def test_bwd_schedule_refuses_what_the_kernels_do_not_take(b, h, t, dh):
    with pytest.raises(ValueError):
        mlstm.bwd_schedule(b, h, t, dh)


@pytest.mark.parametrize("t", [1, 64, 65, 600])
def test_saved_shapes_cover_every_chunk(t):
    s = mlstm.saved_shapes(2, 3, t, 64)
    nc = -(-t // 64)
    assert s == {"states": (2, 3, nc, 65, 64), "m0": (2, 3, nc),
                 "hf": (2, 3, t, 64), "den": (2, 3, t, 2)}


# ---------------------------------------------------------------------------
# the Function, the block and the train step on the CPU
# ---------------------------------------------------------------------------

def test_the_function_runs_the_plain_gradient_on_cpu_tensors():
    """Under autograd a CPU call goes through the Function: the plain
    scan forward, ``ref.mlstm_bwd`` backward (once), no launch; the
    gradients match ``jax.grad``.  ``ops.mlstm`` with ``chunk`` runs the
    chunked plain scan instead, as the reference does."""
    args, cot = _inputs(1, 2, 40, 16, seed=9, scale=0.5)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    before = (mlstm.launches, mlstm.bwd_launches)
    with mock.patch.object(tref, "mlstm_bwd", wraps=tref.mlstm_bwd) as bwd:
        h = mlstm.mlstm_scan(*targs)
        tg = torch.autograd.grad(h, targs, torch.from_numpy(cot))
    assert bwd.call_count == 1
    assert (mlstm.launches, mlstm.bwd_launches) == before
    jg = _jgrads(jref.mlstm_scan, args, cot)
    for g, w in zip(tg, jg):
        _close(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))
    with mock.patch.object(tref, "mlstm_scan_chunked",
                           wraps=tref.mlstm_scan_chunked) as chunked:
        h2 = ops.mlstm(*targs, chunk=8)
    assert chunked.call_count == 1 and torch.equal(h2, h)


@pytest.mark.parametrize("s", [16, 20])
def test_mlstm_block_with_mlstm_chunk_matches_reference(s):
    """``mlstm_chunk = 8``: the block's output and the gradients of x and
    every weight against ``jax.grad`` of the reference's block."""
    jcfg = dataclasses.replace(jconfigs.get_config("xlstm-1.3b").reduced(),
                               dtype="float32", mlstm_chunk=8)
    tcfg = dataclasses.replace(tconfigs.get_config("xlstm-1.3b").reduced(),
                               dtype="float32", mlstm_chunk=8)
    jp = JR.init_mlstm_block(jcfg, jax.random.PRNGKey(s))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(s)
    x = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    leaves = dict(_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = TR.mlstm_block(tcfg, tp, xt)
    tg = torch.autograd.grad(ty, [xt, *leaves.values()],
                             torch.from_numpy(cot))
    jy = JR.mlstm_block(jcfg, jp, jnp.asarray(x))
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(JR.mlstm_block(
        jcfg, p, xx) * cot), argnums=(0, 1))(jp, jnp.asarray(x))
    _close(ty, jy)
    _close(tg[0], jgx)
    jflat = dict(_leaves(jgp))
    for name, g in zip(leaves, tg[1:]):
        w = np.asarray(jflat[name])
        _close(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()) + 1e-6)


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + "/")
        else:
            yield pre + k, v


def test_train_step_with_mlstm_chunk_matches_reference():
    """Reduced xlstm-1.3b with ``mlstm_chunk = 8`` over 24 tokens (the
    chunk divides T), two steps: loss, grad_norm and lr within 1e-5
    relative at both, the params after the first within 1e-5 + 1e-4·lr,
    as ``tests/test_torch_train.py`` holds llama's step.  (After the
    second, AdamW's m/√v at the few embedding entries whose gradient is
    near 0 parts the two by up to 8e-5, with ``mlstm_chunk = 0`` too.)"""
    over = dict(mlstm_chunk=8)
    jcfg = dataclasses.replace(jconfigs.get_config("xlstm-1.3b").reduced(),
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_config("xlstm-1.3b").reduced(),
                               **over)
    kw = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=2)
    jstep = jax.jit(JS.make_train_step(jcfg, None, JOptConfig(**kw)))
    tstep = TS.make_train_step(tcfg, None, OptConfig(**kw))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(11))
    jstate = JS.TrainState(jp, JS.init_opt_state(jp),
                           jnp.zeros((), jnp.int32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tstate = TS.TrainState(tp, TS.init_opt_state(tp),
                           torch.zeros((), dtype=torch.int32))
    rng = np.random.default_rng(12)
    for i in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        if i:
            continue
        lr = float(jm["lr"])
        jflat = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
        for name, t in _leaves(tstate.params):
            np.testing.assert_allclose(
                t.detach().numpy(), jflat[name], rtol=0,
                atol=1e-5 + 1e-4 * lr, err_msg=f"step {i} {name}")
