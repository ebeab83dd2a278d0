"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip
elsewhere.  Run them on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Tolerance in
bf16, elementwise: |kernel - plain| <= 2e-2 + 2e-2 |plain| (both round fp32
sums to bf16, in different orders).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, fused_mlp, gemm, ref  # noqa: E402

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


@pytest.mark.parametrize("b,hq,hk,tq,tk,dh,causal,window,q_offset", [
    (1, 24, 8, 200, 200, 128, True, None, 0),
    (2, 4, 2, 70, 100, 128, True, 16, 30),
    (1, 4, 4, 33, 33, 64, False, None, 0),
    (1, 2, 1, 40, 40, 128, True, 5, 0),
    (1, 2, 2, 8, 8, 64, True, 2, 20),           # every row fully masked
])
def test_flash_attention(dev, b, hq, hk, tq, tk, dh, causal, window,
                         q_offset):
    q = _rand(dev, 2, b, hq, tq, dh)
    k, v = _rand(dev, 3, b, hk, tk, dh), _rand(dev, 4, b, hk, tk, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(flash_attention.flash_attention(q, k, v, **kw),
           ref.attention(q, k, v, **kw))


@pytest.mark.parametrize("m,k,f,n,gated,bias,act", [
    (4, 3072, 8192, 3072, True, False, "silu"),
    (100, 256, 512, 256, False, True, "gelu"),
    (3, 128, 256, 128, True, True, "gelu_exact"),
    (65, 64, 192, 72, True, False, "relu"),
    (256, 3072, 8192, 3072, True, False, "silu"),   # a prefill bucket
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
    """Every F slice the planner may pick sums alike."""
    k, n = 128, 136                                 # a ragged N tile
    x = _rand(dev, 11, m, k)
    w1, wg = (_rand(dev, 12, k, f, scale=k ** -0.5),
              _rand(dev, 13, k, f, scale=k ** -0.5))
    w2 = _rand(dev, 14, f, n, scale=f ** -0.5)
    b1, b2 = _rand(dev, 15, f, scale=0.1), _rand(dev, 16, n, scale=0.1)
    _close(fused_mlp.fused_mlp(x, w1, w2, wg, b1, b2, act="silu",
                               block_f=block_f),
           ref.mlp(x, w1, w2, wg, b1, b2, act="silu"))


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
