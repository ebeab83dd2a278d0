"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip
elsewhere.  Run them on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Tolerance in
bf16, elementwise: |kernel - plain| <= 2e-2 + 2e-2 |plain| (both round fp32
sums to bf16, in different orders).  The mLSTM scan's fp32 state: |kernel -
plain| <= 1e-3 + 1e-3 |plain| (the same recurrence, its products fused and
its sums taken in another order); its gradient's fp32 di and df: |kernel -
plain| <= 1e-3 max|plain| + 1e-3 |plain|.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.ftl import registry  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention, fused_mlp, gemm, gemm_act, mlstm, ops, ref, rg_lru)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no "
                    "interpret mode")
    return torch.device("cuda", 0)


def _rand(dev, seed, *shape, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def _close(out, want):
    torch.cuda.synchronize()
    o, w = out.float(), want.float()
    assert out.shape == want.shape and out.dtype == want.dtype
    assert bool(((o - w).abs() <= 2e-2 + 2e-2 * w.abs()).all()), \
        float((o - w).abs().max())


@pytest.mark.parametrize("m,k,n", [(1024, 3072, 1024), (130, 3000, 129),
                                   (7, 40, 24), (5, 33, 17)])
def test_gemm(dev, m, k, n):
    x, w = _rand(dev, 0, m, k), _rand(dev, 1, k, n, scale=k ** -0.5)
    before = gemm.launches
    _close(gemm.gemm(x, w), ref.gemm(x, w))
    assert gemm.launches == before + 1


# each route of the GEMM tile loops, as kernels/gemm.py:schedule picks it
# on an H100's 132 SMs: full 128 x 256 tiles, full 128 x 128 tiles, ragged
# M and N with a K that is no multiple of 64 (TMA's zero fill), 256-wide
# tiles whose columns span four 64-column TMA boxes with ragged N, split-K
# (granite's MQA wk/wv; a short prefill bucket of its down projection),
# and the mma.sync loop
ROUTES = [((2048, 1024, 6144), "tma", 256),
          ((3072, 768, 3072), "tma", 128),
          ((130, 3000, 136), "tma+splitk=10", 128),
          ((1100, 640, 6136), "tma", 256),
          ((2048, 6144, 128), "tma+splitk=6", 128),
          ((128, 24576, 6144), "tma+splitk=5", 256),
          ((1001, 1003, 3005), "mma.sync", 128)]


@pytest.mark.parametrize("shape,route,block_n", ROUTES)
def test_gemm_routes(dev, shape, route, block_n):
    m, k, n = shape
    x, w = _rand(dev, 11, m, k), _rand(dev, 12, k, n, scale=k ** -0.5)
    s = gemm.plan(x, w)
    if gemm.sm_count(dev.index) == gemm.H100_SMS:
        assert (s.label, s.block_n) == (route, block_n)
    before = gemm.launches
    _close(gemm.gemm(x, w), ref.gemm(x, w))
    assert gemm.launches == before + 1


@pytest.mark.parametrize("shape,route,block_n", ROUTES)
def test_gemm_act_routes(dev, shape, route, block_n):
    m, k, n = shape
    x, w = _rand(dev, 13, m, k), _rand(dev, 14, k, n, scale=k ** -0.5)
    b = _rand(dev, 15, n, scale=0.5)
    assert gemm.plan(x, w).route == route.split("+")[0]
    before = gemm_act.launches
    _close(gemm_act.gemm_act(x, w, b, act="gelu"),
           ref.gemm_act(x, w, b, act="gelu"))
    assert gemm_act.launches == before + 1


def test_gemm_act_split_k_applies_the_activation_to_the_sum(dev):
    """With split-K the bias and gelu follow the sum of the K ranges' fp32
    partials: the kernel agrees with gelu(x @ w + b) and, by far more than
    the tolerance, not with the sum over ranges of gelu(partial + b)."""
    m, k, n = 2048, 6144, 128
    x, w = _rand(dev, 16, m, k), _rand(dev, 17, k, n, scale=k ** -0.5)
    b = _rand(dev, 18, n, scale=0.5)
    s = gemm.plan(x, w)
    assert s.split_k > 1
    got = gemm_act.gemm_act(x, w, b, act="gelu")
    _close(got, ref.gemm_act(x, w, b, act="gelu"))
    xf, wf = x.float(), w.float()
    wrong = sum(ref.act_fn("gelu")(xf[:, k0:k1] @ wf[k0:k1] + b.float())
                for k0, k1 in gemm.k_ranges(k, s.split_k))
    o, v = got.float(), wrong.to(torch.bfloat16).float()
    assert not bool(((o - v).abs() <= 2e-2 + 2e-2 * v.abs()).all())


@pytest.mark.parametrize("shape", [(2048, 6144, 128), (128, 24576, 6144)])
def test_split_k_is_deterministic(dev, shape):
    m, k, n = shape
    x, w = _rand(dev, 19, m, k), _rand(dev, 20, k, n, scale=k ** -0.5)
    b = _rand(dev, 21, n, scale=0.5)
    assert gemm.plan(x, w).split_k > 1
    assert torch.equal(gemm.gemm(x, w), gemm.gemm(x, w))
    assert torch.equal(gemm_act.gemm_act(x, w, b), gemm_act.gemm_act(x, w, b))


def test_gemm_smem_bytes_match_the_launcher(dev):
    from repro_torch.kernels import _build
    assert _build.lib().rt_gemm_smem_bytes() == gemm.SMEM_BYTES


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ["gelu", "gelu_exact", "silu", "relu",
                                 "identity"])
@pytest.mark.parametrize("m,k,n", [(130, 3000, 129), (5, 33, 17),
                                   (128, 6144, 24576), (200, 256, 512)])
def test_gemm_act(dev, m, k, n, act, bias):
    x, w = _rand(dev, 0, m, k), _rand(dev, 1, k, n, scale=k ** -0.5)
    b = _rand(dev, 2, n, scale=0.5) if bias else None
    before = gemm_act.launches
    _close(gemm_act.gemm_act(x, w, b, act=act),
           ref.gemm_act(x, w, b, act=act))
    assert gemm_act.launches == before + 1


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_gemm_act_unaligned_operands(dev, act):
    """Views that start one element into their storage take the
    element-wise loads."""
    m, k, n = 70, 64, 136
    x = _rand(dev, 3, m * k + 1)[1:].view(m, k)
    w = _rand(dev, 4, k * n + 1, scale=k ** -0.5)[1:].view(k, n)
    b = _rand(dev, 5, n + 1, scale=0.5)[1:]
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    _close(gemm_act.gemm_act(x, w, b, act=act),
           ref.gemm_act(x, w, b, act=act))


@pytest.mark.parametrize("m,k,f,n", [(2048, 768, 3072, 768),
                                     (70, 256, 520, 136), (4, 64, 128, 64)])
def test_partial_mlp_executor(dev, m, k, f, n):
    x = _rand(dev, 6, 2, m // 2 or 1, k)
    w1, w2 = _rand(dev, 7, k, f, scale=k ** -0.5), _rand(dev, 8, f, n,
                                                         scale=f ** -0.5)
    b1, b2 = _rand(dev, 9, f, scale=0.1), _rand(dev, 10, n, scale=0.1)
    before = (gemm_act.launches, gemm.launches)
    y = registry.get("cuda_partial_mlp").run(x, w1, w2, None, b1, b2,
                                             act="gelu")
    assert (gemm_act.launches, gemm.launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = ref.mlp(x.reshape(-1, k), w1, w2, None, b1, b2, act="gelu")
    _close(y.reshape(-1, n), want)


# flash attention's schedule on an H100's 132 SMs: (case, tile height).
# 128-row tiles with ragged Tq and Tk at B = 2 and several heads (a store
# past Tq would land in the next head's rows), Dh = 128 and 256 rows of
# V spanning two and four 64-column TMA boxes, a window edge inside a
# 128-key tile, q_offset > 0 with Tq != Tk, and the 64-row schedule
FLASH_SCHEDULES = [
    ((2, 24, 8, 300, 333, 128, False, None, 0), 128),
    ((2, 24, 8, 300, 333, 256, True, None, 0), 128),
    ((1, 48, 1, 1000, 1000, 128, True, None, 0), 128),
    ((1, 48, 1, 700, 700, 256, True, None, 0), 128),
    ((1, 48, 4, 600, 600, 128, True, 100, 0), 128),
    ((2, 32, 8, 260, 900, 128, True, None, 640), 128),
    ((1, 16, 1, 1024, 1024, 256, True, 2048, 0), 64),
    ((1, 8, 8, 448, 1500, 64, False, None, 0), 64),
]


@pytest.mark.parametrize("b,hq,hk,tq,tk,dh,causal,window,q_offset", [
    (1, 24, 8, 200, 200, 128, True, None, 0),
    (2, 4, 2, 70, 100, 128, True, 16, 30),
    (1, 4, 4, 33, 33, 64, False, None, 0),
    (1, 2, 1, 40, 40, 128, True, 5, 0),
    (1, 2, 2, 8, 8, 64, True, 2, 20),           # every row fully masked
    (1, 16, 1, 300, 300, 256, True, 128, 0),    # MQA at head_dim 256
    (1, 16, 1, 700, 700, 256, True, 200, 0),    # tiles below the window
    (2, 4, 1, 50, 90, 256, True, 16, 40),
    (1, 2, 2, 40, 40, 256, False, None, 0),
    (1, 48, 1, 300, 300, 128, True, None, 0),   # granite-20b's MQA 48/1
    # a causal window with more queries than keys: the span's masked
    # loop once ran past the key tiles the producer loads, and hung
    (1, 2, 1, 128, 16, 256, True, 2, 0),
    (1, 2, 1, 200, 64, 128, True, 17, 0),
] + [case for case, _ in FLASH_SCHEDULES])
def test_flash_attention(dev, b, hq, hk, tq, tk, dh, causal, window,
                         q_offset):
    q = _rand(dev, 2, b, hq, tq, dh)
    k, v = _rand(dev, 3, b, hk, tk, dh), _rand(dev, 4, b, hk, tk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    _close(flash_attention.flash_attention(q, k, v, **kw),
           ref.attention(q, k, v, **kw))
    assert flash_attention.launches == before + 1


@pytest.mark.parametrize("block_q", flash_attention.BLOCK_Q)
@pytest.mark.parametrize("case,want_block_q", FLASH_SCHEDULES)
def test_flash_attention_schedules(dev, case, want_block_q, block_q):
    """Each case at the tile height its schedule picks on an H100 and at
    the other one (kernels/flash_attention.py:run_schedule)."""
    b, hq, hk, tq, tk, dh, causal, window, q_offset = case
    if flash_attention.sm_count(dev.index) == flash_attention.H100_SMS:
        assert flash_attention.schedule(*case).block_q == want_block_q
    q = _rand(dev, 12, b, hq, tq, dh, scale=1.5)
    k = _rand(dev, 13, b, hk, tk, dh, scale=1.5)
    v = _rand(dev, 14, b, hk, tk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    s = flash_attention.schedule(*case, block_q=block_q)
    _close(flash_attention.run_schedule(q, k, v, s, **kw),
           ref.attention(q, k, v, **kw))


@pytest.mark.parametrize("b,hq,hk,tq,tk,dh", [
    (1, 8, 8, 1500, 1500, 64),      # whisper-base's encoder
    (1, 64, 8, 1024, 1600, 128),    # llama-3.2-vision-90b's cross-attention
])
def test_flash_attention_not_causal_on_nan_outputs(dev, b, hq, hk, tq, tk,
                                                   dh):
    """The encoder–decoder's and the VLM's served shapes, not causal with
    Tq != Tk or T not a tile multiple: the output filled with NaN first,
    so a row the kernel leaves unwritten shows; two launches give the same
    bits."""
    q = _rand(dev, 21, b, hq, tq, dh)
    k, v = _rand(dev, 22, b, hk, tk, dh), _rand(dev, 23, b, hk, tk, dh)
    kw = dict(causal=False, window=None, q_offset=0)
    s = flash_attention.plan(q, k, **kw)
    outs = []
    for _ in range(2):
        out = torch.full_like(q, float("nan"))
        outs.append(flash_attention.run_schedule(q, k, v, s, out=out, **kw))
    _close(outs[0], ref.attention(q, k, v, **kw))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("b,hq,hk,tq,tk,dh,causal,window,q_offset", [
    (2, 24, 8, 300, 333, 128, True, None, 0),
    (1, 8, 8, 448, 500, 64, False, None, 0),
    (2, 4, 2, 70, 100, 128, True, 16, 30),
    (1, 2, 2, 8, 8, 64, True, 2, 20),           # every row fully masked
    (1, 16, 1, 1000, 1000, 256, True, 256, 0),  # recurrentgemma's, BQ 64
    (1, 16, 1, 3072, 3072, 256, True, 2048, 0),  # its train path, BQ 128
])
def test_flash_attention_lse(dev, b, hq, hk, tq, tk, dh, causal, window,
                             q_offset):
    """The forward kernel with its row logsumexp (training) against
    ``ref.attention_lse``: o in the bf16 rule, lse within 1e-3 + 1e-3
    |lse| (the kernel's exp2 is the approximate one), +inf alike."""
    q = _rand(dev, 20, b, hq, tq, dh)
    k, v = _rand(dev, 21, b, hk, tk, dh), _rand(dev, 22, b, hk, tk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention._forward(q, k, v, with_lse=True, **kw)
    want_o, want_lse = ref.attention_lse(q, k, v, **kw)
    _close(o, want_o)
    inf = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), inf)
    d = (lse - want_lse)[~inf].abs()
    assert bool((d <= 1e-3 + 1e-3 * want_lse[~inf].abs()).all()), \
        float(d.max()) if d.numel() else 0.0
    # and the lse flag leaves the output's bits alone
    assert torch.equal(o, flash_attention._forward(
        q, k, v, with_lse=False, **kw)[0])


@pytest.mark.parametrize("b,hq,hk,tq,tk,dh,causal,window,q_offset", [
    (1, 24, 8, 200, 200, 128, True, None, 0),   # llama's GQA
    (2, 4, 1, 70, 130, 64, True, 16, 60),       # MQA, window, q_offset
    (1, 8, 8, 100, 150, 64, False, None, 0),    # cross-attention
    (1, 2, 2, 8, 8, 64, True, 2, 20),           # every row fully masked
    (1, 16, 1, 1000, 1000, 256, True, 256, 0),  # D = 256, MQA, window
    (1, 16, 1, 3072, 3072, 256, True, 2048, 0),  # recurrentgemma's train
    (2, 4, 1, 130, 130, 256, True, None, 0),    # D = 256, 2 q heads a split
    (1, 24, 8, 600, 600, 128, True, 100, 0),    # GQA with a window
    (1, 48, 1, 700, 700, 128, True, None, 0),   # granite's MQA, split
    # rows that reach both the loop over whole tiles and the masked one in
    # one call: long and not causal, with both window edges masked
    (1, 8, 2, 2048, 2048, 128, False, 700, 0),
    (1, 4, 1, 512, 1024, 64, True, None, 512),  # q_offset > 0 at D = 64
    (2, 8, 4, 777, 777, 128, True, None, 0),    # Tk past the last tile
])
def test_flash_attention_backward(dev, b, hq, hk, tq, tk, dh, causal,
                                  window, q_offset):
    """The backward kernels against ``ref.attention_bwd`` on the same o
    and lse, dO ~ N(0, 1), in the bf16 rule (dK and dV summed over a
    group's q heads in splits where the key tiles leave SMs idle), into
    dq, dk and dv filled with NaN first; two launches give the same bits;
    the autograd Function launches the forward and backward kernels once
    each."""
    q = _rand(dev, 30, b, hq, tq, dh)
    k, v = _rand(dev, 31, b, hk, tk, dh), _rand(dev, 32, b, hk, tk, dh)
    do = _rand(dev, 33, b, hq, tq, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention._forward(q, k, v, with_lse=True, **kw)
    nan = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
    got = flash_attention.run_bwd_schedule(
        q, k, v, o, lse, do, flash_attention.bwd_plan(q, k, **kw), out=nan,
        **kw)
    want = ref.attention_bwd(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention.bwd_launches
    out = ops.attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, do)
    assert (flash_attention.launches, flash_attention.bwd_launches) == \
        (f0 + 1, b0 + 1)
    assert all(torch.equal(x, y) for x, y in zip(grads, got))


def test_kernels_without_backward_raise_under_grad(dev):
    x = _rand(dev, 40, 64, 64).requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        gemm.gemm(x, _rand(dev, 41, 64, 64))
    with torch.no_grad():
        _close(gemm.gemm(x, x), ref.gemm(x, x))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        fused_mlp.fused_mlp(x, _rand(dev, 42, 64, 128), _rand(dev, 43, 128,
                                                              64))
    # head dim 256 has its backward now
    q = _rand(dev, 44, 1, 2, 8, 256).requires_grad_()
    k = _rand(dev, 45, 1, 1, 8, 256)
    out = flash_attention.flash_attention(q, k, k)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"


def test_flash_smem_bytes_match_the_launcher(dev):
    from repro_torch.kernels import _build

    for dh in flash_attention.HEAD_DIMS:
        for bq in flash_attention.BLOCK_Q:
            assert _build.lib().rt_flash_smem_bytes(
                dh, bq, flash_attention.stages_for(dh, bq)) == \
                flash_attention.smem_bytes_for(dh, bq)


@pytest.mark.parametrize("m,k,f,n,gated,bias,act", [
    (4, 3072, 8192, 3072, True, False, "silu"),
    (100, 256, 512, 256, False, True, "gelu"),
    (3, 128, 256, 128, True, True, "gelu_exact"),
    (65, 64, 192, 72, True, False, "relu"),
    (256, 3072, 8192, 3072, True, False, "silu"),   # a prefill bucket
    (4, 4096, 12288, 4096, True, False, "gelu"),    # recurrentgemma decode
    # qwen2-moe-a2.7b's shared experts (decode, a bucket) and
    # moonshot-v1-16b-a3b's
    (4, 2048, 5632, 2048, True, False, "silu"),
    (1024, 2048, 5632, 2048, True, False, "silu"),
    (4, 2048, 2816, 2048, True, False, "silu"),
    (256, 2048, 2816, 2048, True, False, "silu"),
])
def test_fused_mlp(dev, m, k, f, n, gated, bias, act):
    x = _rand(dev, 5, m, k)
    w1, w2 = _rand(dev, 6, k, f, scale=k ** -0.5), _rand(dev, 7, f, n,
                                                         scale=f ** -0.5)
    wg = _rand(dev, 8, k, f, scale=k ** -0.5) if gated else None
    b1 = _rand(dev, 9, f, scale=0.1) if bias else None
    b2 = _rand(dev, 10, n, scale=0.1) if bias else None
    _close(fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act=act),
           ref.mlp(x, w1, w2, wg, b1, b2, act=act))


@pytest.mark.parametrize("m,f,block_f", [
    (70, 768, 64),            # 12 partials
    (70, 768, 192),           # the 64-wide hidden column steps
    (5, 512, 512),            # one slice: one partial
    (130, 1024, 256),
])
def test_fused_mlp_block_f(dev, m, f, block_f):
    """Every F slice the schedule may pick sums alike."""
    k, n = 128, 136                                 # a ragged N tile
    x = _rand(dev, 11, m, k)
    w1, wg = (_rand(dev, 12, k, f, scale=k ** -0.5),
              _rand(dev, 13, k, f, scale=k ** -0.5))
    w2 = _rand(dev, 14, f, n, scale=f ** -0.5)
    b1, b2 = _rand(dev, 15, f, scale=0.1), _rand(dev, 16, n, scale=0.1)
    _close(fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act="silu",
                               block_f=block_f),
           ref.mlp(x, w1, w2, wg, b1, b2, act="silu"))


def _fused_operands(dev, m, k, f, n, gated, bias, seed=20):
    x = _rand(dev, seed, m, k)
    w1 = _rand(dev, seed + 1, k, f, scale=k ** -0.5)
    wg = _rand(dev, seed + 2, k, f, scale=k ** -0.5) if gated else None
    w2 = _rand(dev, seed + 3, f, n, scale=f ** -0.5)
    b1 = _rand(dev, seed + 4, f, scale=0.1) if bias else None
    b2 = _rand(dev, seed + 5, n, scale=0.1) if bias else None
    return x, w1, w2, wg, b1, b2


def _poisoned(dev, m, n, s):
    """Hand the allocator's next blocks for y and the partials back full
    of NaN, so that a chunk the kernel leaves unwritten shows."""
    a = torch.full((m, n), float("nan"), dtype=torch.bfloat16, device=dev)
    b = torch.full((max(1, s.partial_bytes // 4),), float("nan"),
                   device=dev)
    del a, b


# each M tile height with each hidden chunk (the slices picked so that the
# ring keeps three slots with 128-wide chunks, or drops to 64), ragged M
# and N, gated and ungated with biases
@pytest.mark.parametrize("m,n,block_m,block_f,gated,bias", [
    (200, 520, 64, 128, True, False),     # 64-row tiles, 128-wide chunks
    (200, 520, 64, 192, True, True),      # 64-row tiles, 64-wide chunks
    (300, 520, 128, 256, True, False),    # 128-row tiles, 128-wide chunks
    (300, 520, 128, 512, True, True),     # 128-row tiles, 64-wide chunks
    (1, 136, 64, 128, True, True),        # ragged M and N
    (65, 136, 64, 256, False, True),
    (130, 136, 128, 256, False, True),    # a second tile of two rows
    (130, 136, 64, 64, True, False),
])
def test_fused_mlp_tile_heights_and_chunks(dev, m, n, block_m, block_f,
                                           gated, bias):
    k, f = 192, 1536
    x, w1, w2, wg, b1, b2 = _fused_operands(dev, m, k, f, n, gated, bias)
    s = fused_mlp.schedule(m, k, f, n, gated, block_m=block_m,
                           block_f=block_f)
    assert (s.block_m, s.block_f) == (block_m, block_f)
    _poisoned(dev, m, n, s)
    _close(fused_mlp.run_schedule(x, w1, w2, wg, b1, b2, "silu", s),
           ref.mlp(x, w1, w2, wg, b1, b2, act="silu"))


@pytest.mark.parametrize("m,k,f,n", [(4, 3072, 8192, 3072),
                                     (256, 3072, 8192, 3072),
                                     (300, 512, 2048, 776)])
def test_fused_mlp_two_launches_are_bit_identical(dev, m, k, f, n):
    """The partials are summed in slice order, not arrival order: the same
    inputs give the same bits, launch after launch."""
    x, w1, w2, wg, b1, b2 = _fused_operands(dev, m, k, f, n, True, True)
    s = fused_mlp.schedule(m, k, f, n, True)
    before = fused_mlp.launches
    _poisoned(dev, m, n, s)
    y1 = fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act="gelu")
    torch.cuda.synchronize()
    _poisoned(dev, m, n, s)
    y2 = fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act="gelu")
    assert fused_mlp.launches == before + 2
    _close(y1, ref.mlp(x, w1, w2, wg, b1, b2, act="gelu"))
    assert torch.equal(y1, y2)


def test_fused_mlp_counters_are_left_zero(dev):
    """A call right after another on the same stream shares its arrival
    counters: each launch must leave them zero, or the next would sum too
    early or never."""
    from repro_torch.kernels.fused_mlp import _COUNTERS

    shapes = [(70, 128, 768, 520), (300, 256, 1024, 1032), (4, 128, 512, 264)]
    for m, k, f, n in shapes + shapes:
        x, w1, w2, wg, b1, b2 = _fused_operands(dev, m, k, f, n, True, True)
        _close(fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act="silu"),
               ref.mlp(x, w1, w2, wg, b1, b2, act="silu"))
    stream = torch.cuda.current_stream().cuda_stream
    assert int(_COUNTERS[(dev.index, stream)].abs().sum()) == 0


def test_fused_mlp_smem_bytes_match_the_launcher(dev):
    """kernels/fused_mlp.py:smem_bytes, which the schedule sizes the ring
    and the slice by, is the footprint the launcher asks for."""
    from repro_torch.kernels import _build

    for bm in fused_mlp.BLOCK_M:
        for fc in fused_mlp.HIDDEN_CHUNK:
            for bf in (128, 256, 512):
                for gated in (True, False):
                    st = fused_mlp.stages_for(bm, bf, fc, gated)
                    if st < fused_mlp.MIN_STAGES:
                        continue
                    assert _build.lib().rt_fused_mlp_smem_bytes(
                        bm, bf, fc, st, int(gated)) == fused_mlp.smem_bytes(
                            bm, bf, fc, st, gated)
    assert _build.lib().rt_fused_mlp_smem_bytes(96, 128, 64, 3, 1) == -1


@pytest.mark.parametrize("b,t,w,with_h0", [
    (1, 1000, 4000, True),       # T not a chunk multiple
    (2, 37, 13, False),          # W not a multiple of 8: element copies
    (3, 64, 96, True),           # one whole chunk
    (1, 1, 8, False),
    (2, 300, 4100, False),       # a ragged last block of channels
])
def test_rg_lru_scan(dev, b, t, w, with_h0):
    x = _rand(dev, 17, b, t, w, scale=0.5)
    g = torch.Generator(device=dev).manual_seed(18)
    a = (0.79 + 0.2 * torch.rand((b, t, w), generator=g, device=dev)).to(
        torch.bfloat16)
    h0 = torch.randn((b, w), generator=g, device=dev) if with_h0 else None
    h0_copy = None if h0 is None else h0.clone()
    before = rg_lru.launches
    h, h_t = rg_lru.rg_lru_scan(x, a, h0)
    assert rg_lru.launches == before + 1
    want, want_t = ref.rg_lru_scan(x, a, h0)
    _close(h, want)
    assert h_t.dtype == torch.float32
    torch.testing.assert_close(h_t, want_t, rtol=1e-4, atol=1e-4)
    if h0 is not None:
        assert torch.equal(h0, h0_copy)


def test_rg_lru_scan_carries_state_through_padding(dev):
    """Steps with a = 1 and x = 0 (a bucket's padding) leave h_T exactly
    at the last real step's carry."""
    b, t, n, w = 2, 200, 131, 256
    x = _rand(dev, 19, b, t, w, scale=0.5)
    a = torch.full((b, t, w), 0.9, device=dev, dtype=torch.bfloat16)
    x[:, n:] = 0
    a[:, n:] = 1
    _, h_t = rg_lru.rg_lru_scan(x, a)
    _, h_n = rg_lru.rg_lru_scan(x[:, :n].contiguous(), a[:, :n].contiguous())
    assert torch.equal(h_t, h_n)


def _rg_lru_inputs(dev, seed, b, t, w):
    x = _rand(dev, seed, b, t, w, scale=0.5)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    a = (0.79 + 0.2 * torch.rand((b, t, w), generator=g, device=dev)).to(
        torch.bfloat16)
    h0 = torch.randn((b, w), generator=g, device=dev)
    return x, a, h0


def _rg_lru_nan(x, sched):
    """h, h_T and the unit aggregates' scratch filled with NaN, so that a
    check cannot pass on what an earlier launch left in memory."""
    b, _, w = x.shape
    nan = float("nan")
    return dict(out=torch.full_like(x, nan),
                h_t=torch.full((b, w), nan, device=x.device),
                scratch=torch.full((max(1, sched.scratch_bytes // 4),), nan,
                                   device=x.device))


@pytest.mark.parametrize("b,t,w", [
    (1, 4096, 4096),             # recurrentgemma-9b's widest prefill
    (1, 128, 4096),              # its shortest served bucket
    (2, 1000, 4000),             # ragged T and W
    (2, 37, 13),                 # W % 8 != 0: element copies
    (3, 200, 256),
])
def test_rg_lru_scan_is_the_chunked_model_bit_for_bit(dev, b, t, w):
    """Every rounding point of ``chunked_model`` is the kernel's: h and
    h_T equal it bit for bit, with and without h0."""
    x, a, h0 = _rg_lru_inputs(dev, 31, b, t, w)
    sched = rg_lru.schedule(b, t, w)
    for init in (None, h0):
        h, h_t = rg_lru.run_schedule(x, a, init, sched,
                                     **_rg_lru_nan(x, sched))
        want, want_t = rg_lru.chunked_model(x, a, init, sched=sched)
        torch.cuda.synchronize()
        assert torch.equal(h, want) and torch.equal(h_t, want_t)


def test_rg_lru_scan_grid_many_waves_deep(dev):
    """(4, 4096, 4096) with h0: 4096 blocks, about ten waves of the
    card's resident blocks, each waiting on earlier tickets only."""
    x, a, h0 = _rg_lru_inputs(dev, 33, 4, 4096, 4096)
    sched = rg_lru.schedule(4, 4096, 4096)
    assert sched.grid == 4096
    h, h_t = rg_lru.run_schedule(x, a, h0, sched, **_rg_lru_nan(x, sched))
    want, want_t = ref.rg_lru_scan(x, a, h0)
    _close(h, want)
    torch.testing.assert_close(h_t, want_t, rtol=1e-4, atol=1e-4)
    model, model_t = rg_lru.chunked_model(x, a, h0, sched=sched)
    assert torch.equal(h, model) and torch.equal(h_t, model_t)


def test_rg_lru_scan_two_launches_are_bit_identical(dev):
    x, a, h0 = _rg_lru_inputs(dev, 35, 2, 3000, 4096)
    h1, t1 = rg_lru.rg_lru_scan(x, a, h0)
    h2, t2 = rg_lru.rg_lru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2) and torch.equal(t1, t2)


@pytest.mark.parametrize("b,t,w", [(1, 2048, 4096), (2, 700, 264)])
def test_rg_lru_scan_every_schedule_gives_the_same_bits(dev, b, t, w):
    """The values are fixed by the 16-step segments and 64-step units,
    not by the tile or the chunk: other schedules give the default's
    bits."""
    x, a, h0 = _rg_lru_inputs(dev, 37, b, t, w)
    want = rg_lru.rg_lru_scan(x, a, h0)
    for ct, ck in [(64, 128), (128, 64), (32, 256), (8, 64)]:
        sched = rg_lru.schedule(b, t, w, ck, ct)
        got = rg_lru.run_schedule(x, a, h0, sched, **_rg_lru_nan(x, sched))
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rg_lru_footprints_agree_with_the_launcher(dev):
    from repro_torch.kernels import _build
    for ct in rg_lru.CHANNEL_TILES + (24,):
        for chunk in range(32, 1025, 32):
            want = rg_lru.smem_bytes(ct, chunk) if rg_lru.takes(ct, chunk) \
                else -1
            assert _build.lib().rt_rg_lru_smem_bytes(ct, chunk) == want


def test_rg_lru_launcher_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import _build
    x, a, _ = _rg_lru_inputs(dev, 39, 1, 64, 64)
    h, h_t = torch.empty_like(x), torch.empty((1, 64), device=dev)
    sync = torch.zeros(64, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for ct, chunk, b in [(24, 64, 1), (64, 96, 1), (64, 2048, 1),
                         (64, 64, 0), (64, 64, 65536)]:
        rc = _build.lib().rt_rg_lru_scan(
            x.data_ptr(), a.data_ptr(), None, h.data_ptr(), h_t.data_ptr(),
            None, None, sync.data_ptr(), b, 64, 64, ct, chunk, 1, stream)
        assert rc != 0
    with pytest.raises(ValueError):             # not the shape's schedule
        rg_lru.run_schedule(x, a, None, rg_lru.schedule(1, 128, 64))


# ---------------------------------------------------------------------------
# the RG-LRU scan's backward kernel
# ---------------------------------------------------------------------------

def _rg_lru_bwd_run(dev, b, t, w, seed, state, sched=None):
    """The training forward's anchors, then the backward kernel with its
    dx and da filled with NaN first; against ``chunked_bwd_model``."""
    x, a, h0 = _rg_lru_inputs(dev, seed, b, t, w)
    h0 = h0 if state else None
    dh = _rand(dev, seed + 2, b, t, w)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    dh_t = torch.randn((b, w), generator=g, device=dev) if state else None
    _, _, anchors = rg_lru._forward(x, a, h0, with_anchors=True)
    sched = sched or rg_lru.schedule(b, t, w, backward=True)
    nan = float("nan")
    got = rg_lru.rg_lru_scan_bwd(
        x, a, anchors, dh, dh_t, sched=sched, dx=torch.full_like(x, nan),
        da=torch.full_like(a, nan),
        scratch=torch.full((max(1, sched.scratch_bytes // 4),), nan,
                           device=dev))
    model = rg_lru.chunked_bwd_model(x, a, dh, dh_t, h0, sched=sched)
    torch.cuda.synchronize()
    return (x, a, h0, dh, dh_t, anchors), got, model


@pytest.mark.parametrize("b,t,w,state", [
    (1, 1, 8, True),             # one step: c = 1, dh0 = a_0 (dh_0 + dh_T)
    (2, 63, 64, False),          # one unit, cut
    (1, 64, 64, True),           # one whole unit
    (1, 65, 64, True),           # a second unit of one step
    (2, 1000, 4000, True),       # a ragged last chunk and tile
    (2, 37, 13, True),           # W % 8 != 0: element copies
    (1, 3072, 4096, False),      # recurrentgemma-9b's train path
    (4, 1024, 4096, True),       # many chunks, four rows
])
def test_rg_lru_backward_is_the_chunked_model_bit_for_bit(dev, b, t, w,
                                                          state):
    """dx, da and dh0 equal ``chunked_bwd_model`` bit for bit, and the
    plain backward within the bf16 rule (dh0, fp32, within 1e-4); two
    launches give the same bits."""
    args, got, model = _rg_lru_bwd_run(dev, b, t, w, 51, state)
    assert all(torch.equal(p, q) for p, q in zip(got, model))
    x, a, h0, dh, dh_t, anchors = args
    want = ref.rg_lru_bwd(x, a, h0, dh, dh_t)
    _close(got[0], want[0])
    _close(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    again = rg_lru.rg_lru_scan_bwd(x, a, anchors, dh, dh_t)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("b,t,w", [(1, 2048, 4096), (2, 700, 264)])
def test_rg_lru_backward_every_schedule_gives_the_same_bits(dev, b, t, w):
    want = None
    for ct, ck in [(64, 256), (64, 128), (128, 64), (32, 256), (8, 64)]:
        sched = rg_lru.schedule(b, t, w, ck, ct, backward=True)
        _, got, model = _rg_lru_bwd_run(dev, b, t, w, 53, True, sched)
        assert all(torch.equal(p, q) for p, q in zip(got, model))
        want = want or got
        assert all(torch.equal(p, q) for p, q in zip(got, want))


def test_rg_lru_anchors_leave_h_alone_and_are_the_models_carries(dev):
    """The training build writes the carry at each unit's start and the
    same h and h_T as serving's build."""
    x, a, h0 = _rg_lru_inputs(dev, 55, 2, 1000, 4000)
    h, h_t, anchors = rg_lru._forward(x, a, h0, with_anchors=True)
    hs, h_ts = rg_lru.rg_lru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, hs) and torch.equal(h_t, h_ts)
    assert anchors.shape == rg_lru.anchor_shape(2, 1000, 4000)
    for u in range(anchors.shape[1]):
        if u == 0:
            assert torch.equal(anchors[:, 0], h0)
            continue
        _, carry = rg_lru.chunked_model(
            x[:, :64 * u].contiguous(), a[:, :64 * u].contiguous(), h0,
            sched=rg_lru.schedule(2, 64 * u, 4000))
        assert torch.equal(anchors[:, u], carry), u


def test_rg_lru_function_launches_both_kernels(dev):
    """Under autograd the scan's Function launches the training forward
    once and the backward once, and gives the kernels' gradients."""
    x, a, h0 = _rg_lru_inputs(dev, 57, 1, 300, 256)
    dh = _rand(dev, 58, 1, 300, 256)
    ts = [x.clone().requires_grad_(), a.clone().requires_grad_(),
          h0.clone().requires_grad_()]
    f0, b0 = rg_lru.launches, rg_lru.bwd_launches
    h, _ = ops.rg_lru(*ts)
    grads = torch.autograd.grad(h, ts, dh)
    assert (rg_lru.launches, rg_lru.bwd_launches) == (f0 + 1, b0 + 1)
    _, _, anchors = rg_lru._forward(x, a, h0, with_anchors=True)
    want = rg_lru.rg_lru_scan_bwd(x, a, anchors, dh, None)
    assert all(torch.equal(p, q) for p, q in zip(grads, want))
    # and the plain Function on the card launches neither kernel
    f1, b1 = rg_lru.launches, rg_lru.bwd_launches
    plain = torch.autograd.grad(ops.rg_lru(*ts, backend="ref")[0], ts, dh)
    assert (rg_lru.launches, rg_lru.bwd_launches) == (f1, b1)
    _close(grads[0], plain[0])
    _close(grads[1], plain[1])


def test_flash_bwd_footprints_agree_with_the_launcher(dev):
    """Each backward kernel's footprint (``bwd_smem_bytes``, which
    ``bwd_schedule`` sizes its rings by) is what the launcher asks for, at
    the tile each head dim builds and every ring depth; -1 where no build
    takes the tile."""
    from repro_torch.kernels import _build
    fa = flash_attention
    for dh in (32, *fa.HEAD_DIMS):
        for kern, (name, tiles) in enumerate((("dkdv", fa.BWD_BLOCK_K),
                                              ("dq", fa.BWD_BLOCK_Q))):
            for tile in (64, 128):
                for st in range(2, fa.MAX_STAGES + 1):
                    built = tiles.get(dh) == tile
                    want = (fa.bwd_smem_bytes(name, dh, tile, st) if built
                            else -1)
                    assert _build.lib().rt_flash_bwd_smem_bytes(
                        kern, dh, tile, st) == want, (name, dh, tile, st)


def _on_a_fresh_thread(fn):
    """fn() on a new thread, as autograd runs a backward: no runtime call
    has bound the device's context there before the launcher's."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:          # handed to the test's thread
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "error" in box:
        raise box["error"]
    return box["out"]


@pytest.mark.parametrize("kernel", ["rg_lru_scan_bwd", "flash_attention_bwd",
                                    "flash_attention", "mlstm_scan_bwd"])
def test_tensor_map_launchers_run_first_on_a_fresh_thread(dev, kernel):
    """A launcher that encodes TMA tensor maps, called first on a thread
    of its own, gives the bits it gives on the test's thread: the encoder
    binds the context itself.  Every output is made on the test's thread
    (and the allocator's blocks warmed there), so that the launcher is the
    first runtime call on the new one."""
    if kernel == "rg_lru_scan_bwd":
        x, a, _ = _rg_lru_inputs(dev, 59, 2, 700, 264)
        dh = _rand(dev, 60, 2, 700, 264)
        _, _, anchors = rg_lru._forward(x, a, None, with_anchors=True)
        sched = rg_lru.schedule(2, 700, 264, backward=True)
        outs = [dict(dx=torch.empty_like(x), da=torch.empty_like(a),
                     scratch=torch.empty((max(1, sched.scratch_bytes // 4),),
                                         device=dev)) for _ in range(2)]

        def call(i):
            return rg_lru.rg_lru_scan_bwd(x, a, anchors, dh, sched=sched,
                                          **outs[i])
    elif kernel == "mlstm_scan_bwd":
        args, saved, dh = _mlstm_bwd_case(dev, 65, 1, 2, 200, 256)
        sched = mlstm.bwd_schedule(1, 2, 200, 256)
        outs = [dict(grads=tuple(torch.empty_like(t) for t in args),
                     scratch=torch.empty((sched.scratch_bytes // 4,),
                                         device=dev)) for _ in range(2)]

        def call(i):
            return mlstm.mlstm_scan_bwd(*args, saved, dh, **outs[i])
    else:
        q = _rand(dev, 61, 1, 8, 300, 128)
        k, v = _rand(dev, 62, 1, 2, 300, 128), _rand(dev, 63, 1, 2, 300, 128)
        kw = dict(causal=True, window=None, q_offset=0)
        o, lse = flash_attention._forward(q, k, v, with_lse=True, **kw)
        do = _rand(dev, 64, 1, 8, 300, 128)
        outs = [tuple(torch.empty_like(t) for t in (q, k, v))
                for _ in range(2)]
        s = flash_attention.bwd_plan(q, k, **kw)
        fs = flash_attention.plan(q, k, **kw)

        def call(i):
            if kernel == "flash_attention":
                return (flash_attention.run_schedule(q, k, v, fs, **kw),)
            return flash_attention.run_bwd_schedule(q, k, v, o, lse, do, s,
                                                    out=outs[i], **kw)
    want = call(0)
    torch.cuda.synchronize()
    got = _on_a_fresh_thread(lambda: call(1))
    assert all(torch.equal(p, w) for p, w in zip(got, want))


def test_rg_lru_bwd_footprints_agree_with_the_launcher(dev):
    from repro_torch.kernels import _build
    for ct in rg_lru.CHANNEL_TILES + (24,):
        for chunk in range(32, 1025, 32):
            want = (rg_lru.bwd_smem_bytes(ct, chunk)
                    if rg_lru.takes(ct, chunk, backward=True) else -1)
            assert _build.lib().rt_rg_lru_bwd_smem_bytes(ct, chunk) == want


def _mlstm_inputs(dev, seed, b, h, t, dh):
    """bf16 q, k, v and fp32 gates, the forget gate shifted by 3 as the
    model shifts it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (_rand(dev, seed + i, b, h, t, dh) for i in range(3))
    i_pre = torch.randn((b, h, t), generator=g, device=dev)
    f_pre = torch.randn((b, h, t), generator=g, device=dev) + 3.0
    return q, k, v, i_pre, f_pre


def _state_close(got, want):
    for name in ("C", "n", "m"):
        assert got[name].dtype == torch.float32
        torch.testing.assert_close(got[name], want[name], rtol=1e-3,
                                   atol=1e-3)


def _nan_buffers(dev, sched, b, h, dh, with_state):
    """The state and the Q Kᵀ scratch filled with NaN (the callers fill
    h too), so that a check cannot pass on what an earlier launch left
    in memory."""
    nan = float("nan")
    state = None
    if with_state:
        state = {"C": torch.full((b, h, dh, dh), nan, device=dev),
                 "n": torch.full((b, h, dh), nan, device=dev),
                 "m": torch.full((b, h), nan, device=dev)}
    scratch = torch.full((sched.scratch_bytes // 4,), nan, device=dev)
    return state, scratch


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,h,t,dh", [
    (1, 4, 300, 1024),           # xlstm-1.3b's head dim, a ragged chunk
    (1, 4, 2048, 1024),          # its prefill at the largest bucket
    (2, 2, 1000, 128),           # the reduced config's head dim
    (1, 1, 7, 32),               # one partial chunk, a padded tile
    (3, 2, 64, 96),              # one whole chunk, no power of two
    (1, 2, 65, 256),             # one step past a chunk
    (1, 2, 129, 160),
    (2, 1, 40, 512),
])
def test_mlstm_scan(dev, b, h, t, dh, with_state):
    args = _mlstm_inputs(dev, 21, b, h, t, dh)
    sched = mlstm.schedule(b, h, t, dh)
    state, scratch = _nan_buffers(dev, sched, b, h, dh, with_state)
    out = torch.full_like(args[0], float("nan"))
    before = mlstm.launches
    got = mlstm.run_schedule(*args, sched, return_state=with_state, out=out,
                             state=state, scratch=scratch)
    assert mlstm.launches == before + 1
    want = ref.mlstm_scan(*args, return_state=with_state)
    if with_state:
        _close(got[0], want[0])
        _state_close(got[1], want[1])
    else:
        _close(got, want)


def test_mlstm_scan_two_launches_are_bit_identical(dev):
    args = _mlstm_inputs(dev, 29, 1, 4, 600, 1024)
    h1, s1 = mlstm.mlstm_scan(*args, return_state=True)
    h2, s2 = mlstm.mlstm_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    assert all(torch.equal(s1[n], s2[n]) for n in ("C", "n", "m"))


def test_mlstm_footprints_agree_with_the_launcher(dev):
    from repro_torch.kernels import _build
    st = mlstm.stages_for()
    assert _build.lib().rt_mlstm_smem_bytes(st) == mlstm.smem_bytes_for(st)
    assert _build.lib().rt_mlstm_qk_smem_bytes() == mlstm.qk_smem_bytes()
    for dh in range(32, mlstm.MAX_HEAD_DIM + 1, 32):
        s = mlstm.bwd_schedule(1, 1, 64, dh)
        assert [_build.lib().rt_mlstm_bwd_smem_bytes(k, dh)
                for k in range(3)] == [s.prep_smem_bytes,
                                       s.state_smem_bytes,
                                       s.grad_smem_bytes]
    assert s.state_smem_bytes == mlstm.bwd_state_smem_bytes(
        mlstm.BWD_STATE_STAGES)
    for dh in (0, 48, 1056):
        assert _build.lib().rt_mlstm_bwd_smem_bytes(1, dh) == -1


def _mlstm_bwd_case(dev, seed, b, h, t, dh):
    """The inputs, the training forward's saved tensors and dh ~ N(0, 1)
    in bf16."""
    args = _mlstm_inputs(dev, seed, b, h, t, dh)
    _, saved = mlstm._forward(*args, return_state=False, train=True)
    return args, saved, _rand(dev, seed + 9, b, h, t, dh)


def _gates_close(got, want, share=1e-3):
    """di, df in fp32 within share·max|want| + share·|want|: the row dots
    and the cumulative sum taken in another order than autograd's."""
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = share * float(want.abs().max()) + share * want.abs()
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


MLSTM_BWD = [
    (1, 4, 300, 1024),           # xlstm-1.3b's head dim, a ragged chunk
    (2, 2, 1000, 128),           # the reduced config's head dim
    (1, 1, 7, 32),               # one partial chunk
    (3, 2, 64, 96),              # one whole chunk, a half column tile
    (1, 2, 129, 160),
    (2, 3, 50, 320),             # one chunk: no end-gradient stored
    (1, 2, 200, 544),            # Dh not a multiple of 256
]


@pytest.mark.parametrize("b,h,t,dh", MLSTM_BWD)
def test_mlstm_bwd_matches_the_plain_gradient(dev, b, h, t, dh):
    """The backward kernels on NaN-filled outputs and scratch, against
    ``ref.mlstm_bwd`` (autograd through the plain scan) by the bf16 rule
    and the gates' rule, and against ``chunkwise_bwd_model`` (the
    kernels' arithmetic) ten times tighter on the gates: bit for bit it
    cannot be, as the model's fp32 matrix products sum in cuBLAS's order,
    not the tensor cores'."""
    args, saved, dh_ = _mlstm_bwd_case(dev, 31, b, h, t, dh)
    nan = float("nan")
    grads = tuple(torch.full_like(x, nan) for x in args)
    s = mlstm.bwd_schedule(b, h, t, dh)
    scratch = torch.full((s.scratch_bytes // 4,), nan, device=dev)
    before = mlstm.bwd_launches
    got = mlstm.mlstm_scan_bwd(*args, saved, dh_, grads=grads,
                               scratch=scratch)
    assert mlstm.bwd_launches == before + 1
    want = ref.mlstm_bwd(*args, dh_)
    model = mlstm.chunkwise_bwd_model(*args, dh_)
    for j in range(3):
        _close(got[j], want[j])
        _close(got[j], model[j])
    for j in (3, 4):
        _gates_close(got[j], want[j])
        _gates_close(got[j], model[j], share=1e-4)


def test_mlstm_bwd_two_launches_are_bit_identical(dev):
    args, saved, dh_ = _mlstm_bwd_case(dev, 33, 2, 2, 600, 256)
    g1 = mlstm.mlstm_scan_bwd(*args, saved, dh_)
    g2 = mlstm.mlstm_scan_bwd(*args, saved, dh_)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_mlstm_bwd_is_bit_identical_over_many_launches(dev):
    """200 launches at xlstm-1.3b's head dim over 8 chunks (the state
    pass's chunk buffers reused, its ring cycled 32 times a block), each
    the first's bits: a ring whose slots served another owner each time
    gave other bits now and then, then a launch failure."""
    args, saved, dh_ = _mlstm_bwd_case(dev, 39, 4, 4, 512, 1024)
    first = mlstm.mlstm_scan_bwd(*args, saved, dh_)
    for _ in range(199):
        again = mlstm.mlstm_scan_bwd(*args, saved, dh_)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("train", [False, True], ids=["serving", "training"])
def test_mlstm_scan_is_bit_identical_over_many_launches(dev, train):
    """200 launches with state at xlstm-1.3b's head dim over 8 chunks
    (the ring cycled 32 times a block), each the first's bits, in the
    serving build and in the training build (its saved tensors too): a
    ring whose slots served another owner each time gave the backward's
    state pass other bits now and then, then a launch failure."""
    b, h, t, dh = 4, 4, 512, 1024
    args = _mlstm_inputs(dev, 41, b, h, t, dh)
    sched = mlstm.schedule(b, h, t, dh)
    assert sched.stages % mlstm.OWNERS == 0

    def run():
        saved = ({n: torch.empty(sh, device=dev) for n, sh in
                  mlstm.saved_shapes(b, h, t, dh).items()} if train
                 else None)
        out, st = mlstm.run_schedule(*args, sched, return_state=True,
                                     saved=saved)
        return [out, st["C"], st["n"], st["m"],
                *(saved.values() if train else ())]

    first = run()
    for _ in range(199):
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("b,h,t,dh", [(1, 2, 130, 128), (2, 1, 200, 96)])
def test_mlstm_training_forward_saves_the_model_s_tensors(dev, b, h, t, dh):
    """The training build's h is the serving build's, bit for bit, and
    what it saves is ``chunkwise_model``'s within the state's rule; its
    outputs are NaN-filled first."""
    args = _mlstm_inputs(dev, 35, b, h, t, dh)
    sched = mlstm.schedule(b, h, t, dh)
    saved = {n: torch.full(sh, float("nan"), device=dev)
             for n, sh in mlstm.saved_shapes(b, h, t, dh).items()}
    h_train = mlstm.run_schedule(*args, sched, saved=saved)
    assert torch.equal(h_train, mlstm.mlstm_scan(*args))
    _, kept = mlstm.chunkwise_model(*args, saved=True)
    for n in kept:
        torch.testing.assert_close(saved[n], kept[n], rtol=1e-3, atol=1e-3)


def test_mlstm_function_trains_through_both_kernels(dev):
    """Under autograd a CUDA call launches the training forward once and
    the backward once; ``return_state`` under autograd raises (the final
    state has no backward kernel)."""
    args = [x.detach().requires_grad_() for x in
            _mlstm_inputs(dev, 37, 1, 2, 100, 128)]
    dh_ = _rand(dev, 38, 1, 2, 100, 128)
    before = (mlstm.launches, mlstm.bwd_launches)
    h = mlstm.mlstm_scan(*args)
    got = torch.autograd.grad(h, args, dh_)
    assert (mlstm.launches, mlstm.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = ref.mlstm_bwd(*[x.detach() for x in args], dh_)
    for j in range(3):
        _close(got[j], want[j])
    for j in (3, 4):
        _gates_close(got[j], want[j])
    with pytest.raises(NotImplementedError):
        mlstm.mlstm_scan(*args, return_state=True)


def test_mlstm_scan_carries_state_through_padding(dev):
    """Steps with i = -inf, f = +inf (a bucket's padding) leave the state
    exactly at the last real step's, and the real steps' h unchanged."""
    b, h, t, n, dh = 2, 2, 200, 131, 256
    q, k, v, i_pre, f_pre = _mlstm_inputs(dev, 23, b, h, t, dh)
    i_pad, f_pad = i_pre.clone(), f_pre.clone()
    i_pad[..., n:] = float("-inf")
    f_pad[..., n:] = float("inf")
    out, st = mlstm.mlstm_scan(q, k, v, i_pad, f_pad, return_state=True)
    cut = [x[:, :, :n].contiguous() for x in (q, k, v, i_pre, f_pre)]
    out_n, st_n = mlstm.mlstm_scan(*cut, return_state=True)
    for name in ("C", "n", "m"):
        assert torch.equal(st[name], st_n[name])
    assert torch.equal(out[:, :, :n], out_n)
    assert bool(torch.isfinite(out.float()).all())
    _state_close(st, ref.mlstm_scan(*cut, return_state=True)[1])


def test_ops_mlstm_launches_with_and_without_state(dev):
    args = _mlstm_inputs(dev, 25, 1, 2, 33, 128)
    before = mlstm.launches
    ops.mlstm(*args)
    ops.mlstm(*args, return_state=True)
    assert mlstm.launches == before + 2
    ref.mlstm_scan(*args, return_state=True)
    assert mlstm.launches == before + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _rand(dev, 0, 8, 16)
    with pytest.raises(TypeError):
        gemm.gemm(x.float(), x.float().T.contiguous())
    with pytest.raises(ValueError):
        gemm.gemm(x, x)                             # K mismatch
    with pytest.raises(ValueError):
        gemm.gemm(x, x.cpu().T.contiguous())        # mixed devices
    q = _rand(dev, 1, 1, 2, 8, 32)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)    # head_dim 32
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp(x, _rand(dev, 2, 16, 40), _rand(dev, 3, 40, 16))
    w1, w2 = _rand(dev, 4, 16, 128), _rand(dev, 5, 128, 16)
    with pytest.raises(ValueError):                 # slice not dividing F
        fused_mlp.fused_mlp(x, w1, w2, block_f=96)
    with pytest.raises(ValueError):                 # bias of K entries
        gemm_act.gemm_act(x, x.T.contiguous(), x[0])
    with pytest.raises(ValueError):
        gemm_act.gemm_act(x, x.T.contiguous(), act="tanh")
    xs = _rand(dev, 6, 1, 8, 16)
    with pytest.raises(TypeError):
        rg_lru.rg_lru_scan(xs.float(), xs.float())
    with pytest.raises(ValueError):                 # h0 not (B, W) fp32
        rg_lru.rg_lru_scan(xs, xs, xs[:, 0])
    q = _rand(dev, 7, 1, 2, 8, 64)
    gate = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(TypeError):                  # bf16 gates
        mlstm.mlstm_scan(q, q, q, gate.bfloat16(), gate.bfloat16())
    with pytest.raises(ValueError):                 # head dim 48
        q48 = _rand(dev, 8, 1, 2, 8, 48)
        mlstm.mlstm_scan(q48, q48, q48, gate, gate)
    with pytest.raises(ValueError):                 # gates of another T
        mlstm.mlstm_scan(q, q, q, gate[..., :4], gate[..., :4])
    with pytest.raises(ValueError):                 # not contiguous
        mlstm.mlstm_scan(q.transpose(1, 2), q, q, gate, gate)


# ---------------------------------------------------------------------------
# the MoE layer on the card
# ---------------------------------------------------------------------------

def test_moe_layer_on_the_card_matches_the_cpu(dev):
    """One qwen2-moe-a2.7b layer at full width (60 experts of 1408, top-4,
    the 5632-wide shared MLP on the fused-MLP kernel) on 256 tokens, bf16,
    against the same layer on the CPU (the plain fused MLP): the fp32
    router's choices compared (token, slot) by (token, slot), at most 1%
    swapped (a near tie may fall either way after the card's fp32
    product), and y, on the tokens whose choices agree, within the bf16
    rule; the kernel launched once, the aux within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import tree_map

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              ftl_mode="fused")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                     torch.device("cpu"))
    x = (torch.randn((1, 256, cfg.d_model),
                     generator=torch.Generator().manual_seed(1))
         ).to(torch.bfloat16)
    pd = tree_map(lambda t: t.to(dev), p)
    before = fused_mlp.launches
    y, aux = moe.moe_layer(cfg, pd, x.to(dev))
    assert fused_mlp.launches == before + 1
    want, want_aux = moe.moe_layer(cfg, p, x)
    _, _, idx = moe.route(cfg, pd, x.to(dev).reshape(1, 256, -1))
    _, _, want_idx = moe.route(cfg, p, x.reshape(1, 256, -1))
    same = (idx.cpu() == want_idx)[0]
    assert float((~same).float().mean()) <= 0.01
    rows = same.all(-1)
    o, w = y.float().cpu()[0][rows], want.float()[0][rows]
    assert bool(((o - w).abs() <= 2e-2 + 2e-2 * w.abs()).all()), \
        float((o - w).abs().max())
    assert abs(float(aux) - float(want_aux)) <= 1e-4
