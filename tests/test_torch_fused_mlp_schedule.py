"""The fused-MLP kernel's schedule (``repro_torch.kernels.fused_mlp``), on
the CPU.

``fused_mlp`` launches what :func:`fused_mlp.schedule` picks from the shape
alone: the M tile (64 rows up to M = 256, else 128), the F slice, the hidden chunk, the
ring's slots, the grid, the shared memory and the scratch (the fp32
partials and the arrival counters); the kernel sums a chunk's partials in
slice order as :func:`fused_mlp.sum_partials` does.  These tests hold both
at the served models' widths, at decode (M = 4 slots) and at every prefill
bucket, on an H100's 132 SMs.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.core.ftl.solver import InfeasibleError  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.model import PREFILL_BUCKETS  # noqa: E402

SMS = 132
# (K, F, N, gated) of the models whose MLPs the kernel can run
WIDTHS = {"llama3.2-3b": (3072, 8192, 3072, True),
          "recurrentgemma-9b": (4096, 12288, 4096, True),
          "granite-20b": (6144, 24576, 6144, False)}
CASES = [(arch, m) for arch in WIDTHS for m in (4, *PREFILL_BUCKETS)]


def _sched(arch, m):
    k, f, n, gated = WIDTHS[arch]
    return fm.schedule(m, k, f, n, gated, SMS)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("arch,m", CASES)
def test_footprint_fits_a_block_and_is_the_launchers_formula(arch, m):
    """The C launcher's rt_fused_mlp_smem_bytes: the 1 KB that aligns the
    ring to the swizzle, h (BM x BF bf16), the ring's slots (the larger of
    an up step, x and w1 [and wg] tiles, and a down step, a w2 tile) and
    512 B of barriers (the ring's and the count queue's)."""
    _, _, _, gated = WIDTHS[arch]
    s = _sched(arch, m)
    up = s.block_m * 64 * 2 + (2 if gated else 1) * 64 * s.hidden_chunk * 2
    down = 64 * s.block_n * 2
    want = 1024 + s.block_m * s.block_f * 2 + s.stages * max(up, down) + 512
    assert s.smem_bytes == want == fm.smem_bytes(
        s.block_m, s.block_f, s.hidden_chunk, s.stages, gated)
    assert s.smem_bytes <= 232_448 == fm.SMEM_LIMIT
    # the ring takes every slot that fits, up to the kernel's eight
    assert fm.MIN_STAGES <= s.stages <= fm.MAX_STAGES
    assert s.stages == fm.MAX_STAGES or want + max(up, down) > 232_448


@pytest.mark.parametrize("arch,m", CASES)
def test_slice_divides_f_and_the_hidden_chunk_divides_the_slice(arch, m):
    _, f, _, _ = WIDTHS[arch]
    s = _sched(arch, m)
    assert s.block_f % 64 == 0 and f % s.block_f == 0
    assert s.hidden_chunk in fm.HIDDEN_CHUNK
    assert s.block_f % s.hidden_chunk == 0
    assert s.block_m == (64 if m <= 256 else 128)
    assert s.block_n == 256


@pytest.mark.parametrize("arch,m", CASES)
def test_hidden_chunk_is_the_wider_where_three_slots_still_fit(arch, m):
    """128 hidden columns a pass where the slice takes them and the ring
    keeps three slots beside h; else 64, for the deeper ring."""
    _, _, _, gated = WIDTHS[arch]
    s = _sched(arch, m)
    wide = fm.stages_for(s.block_m, s.block_f, 128, gated)
    want = 128 if s.block_f % 128 == 0 and wide >= 3 else 64
    assert s.hidden_chunk == want


@pytest.mark.parametrize("arch,m", CASES)
def test_grid_covers_every_m_tile_and_f_slice_once(arch, m):
    _, f, _, _ = WIDTHS[arch]
    s = _sched(arch, m)
    tiles, slices = _cdiv(m, s.block_m), f // s.block_f
    assert s.grid == tiles * slices
    seen = [fm.block_of(b, tiles, slices) for b in range(s.grid)]
    assert sorted(seen) == [(t, j) for t in range(tiles)
                            for j in range(slices)]
    # inside a group the tile is fastest: the blocks of one slice are
    # neighbours, and a group's tiles finish their partials together
    assert seen[:min(tiles, fm.GROUP_M)] == [
        (t, 0) for t in range(min(tiles, fm.GROUP_M))]


@pytest.mark.parametrize("arch,m", CASES)
def test_scratch_is_the_partials_and_the_counters(arch, m):
    _, f, n, _ = WIDTHS[arch]
    s = _sched(arch, m)
    assert s.partial_bytes == 4 * (f // s.block_f) * m * n
    assert s.counter_bytes == 4 * _cdiv(m, 64) * _cdiv(n, 256)


@pytest.mark.parametrize("arch,bf", [("llama3.2-3b", 128),
                                     ("recurrentgemma-9b", 256),
                                     ("granite-20b", 384)])
def test_decode_takes_the_narrowest_128_multiple_on_half_the_sms(arch, bf):
    """At M = 4 the slice is the narrowest multiple of 128 whose grid is
    at most half the SMs: every narrower multiple of 128 would take
    more."""
    _, f, _, gated = WIDTHS[arch]
    s = _sched(arch, 4)
    assert (s.block_m, s.block_f) == (64, bf)
    assert s.grid <= SMS // 2
    narrower = [c for c in fm.block_f_choices(f, 64, gated)
                if c < s.block_f and c % 128 == 0]
    assert all(f // c > SMS // 2 for c in narrower)


@pytest.mark.parametrize("s,m,n,bias", [
    (1, 64, 256, False), (16, 130, 300, True), (5, 1, 8, True),
    (128, 4, 520, False)])
def test_fixed_order_sum_is_the_plain_sum_bit_for_bit(s, m, n, bias):
    """The kernel's chunk-by-chunk sum, in slice order, then b2 in fp32,
    equals a plain running sum over the whole tensor to the bit."""
    rng = np.random.default_rng(s * 1000 + m)
    part = torch.from_numpy(rng.standard_normal((s, m, n)).astype(
        np.float32))
    b2 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        torch.bfloat16) if bias else None
    acc = part[0].clone()
    for i in range(1, s):
        acc = acc + part[i]
    if bias:
        acc = acc + b2.float()
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(fm.sum_partials(part, b2, dtype), acc.to(dtype))


def test_the_sum_order_is_fixed_not_free():
    """Another order gives other fp32 bits: the slice order is what makes
    the kernel's y the same from launch to launch."""
    rng = np.random.default_rng(3)
    part = torch.from_numpy(rng.standard_normal((16, 64, 256)).astype(
        np.float32))
    fwd = fm.sum_partials(part, None, torch.float32)
    rev = fm.sum_partials(part.flip(0), None, torch.float32)
    assert not torch.equal(fwd, rev)
    torch.testing.assert_close(fwd, rev)


@pytest.mark.parametrize("gated,act,block_f", [
    (True, "silu", 64), (True, "gelu", 128), (False, "gelu", 192)])
def test_split_f_sum_matches_the_plain_mlp(gated, act, block_f):
    """The kernel's arithmetic on the CPU: each slice's h formed in fp32
    and rounded to bf16, its fp32 partial of h @ w2, the partials summed
    in slice order with b2: the plain MLP within the bf16 tolerance."""
    rng = np.random.default_rng(11)
    m, k, f, n = 70, 64, 384, 136

    def bf(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(torch.bfloat16)

    x, w1, w2 = bf(m, k), bf(k, f, scale=k ** -0.5), bf(f, n, scale=f ** -0.5)
    wg = bf(k, f, scale=k ** -0.5) if gated else None
    b1, b2 = bf(f, scale=0.1), bf(n, scale=0.1)
    parts = []
    for f0 in range(0, f, block_f):
        sl = slice(f0, f0 + block_f)
        h = ref.act_fn(act)(x.float() @ w1[:, sl].float() + b1[sl].float())
        if gated:
            h = h * (x.float() @ wg[:, sl].float())
        parts.append(h.to(torch.bfloat16).float() @ w2[sl].float())
    y = fm.sum_partials(torch.stack(parts), b2)
    want = ref.mlp(x, w1, w2, wg, b1, b2, act=act)
    assert bool(((y.float() - want.float()).abs()
                 <= 2e-2 + 2e-2 * want.float().abs()).all())


@pytest.mark.parametrize("arch", WIDTHS)
def test_a_slice_and_a_tile_height_can_be_asked_for(arch):
    k, f, n, gated = WIDTHS[arch]
    for bm in fm.BLOCK_M:
        for bf in fm.block_f_choices(f, bm, gated)[:3]:
            s = fm.schedule(1024, k, f, n, gated, SMS, block_m=bm,
                            block_f=bf)
            assert (s.block_m, s.block_f) == (bm, bf)


@pytest.mark.parametrize("kw,exc", [
    (dict(block_f=96), ValueError),          # not on the 64 lattice
    (dict(block_f=8192 + 64), ValueError),    # does not divide F
    (dict(block_m=32), ValueError),
    (dict(block_f=4096), ValueError),         # h alone overflows a block
    (dict(smem_limit=16 * 1024), InfeasibleError),
])
def test_schedule_refuses_what_the_kernel_does_not_take(kw, exc):
    with pytest.raises(exc):
        fm.schedule(1024, 3072, 8192, 3072, True, SMS, **kw)


def test_the_registry_qualifies_the_kernel_on_its_footprint():
    cap = thw.H100.fast.capacity_bytes
    assert fm.min_smem_bytes(True) <= cap
    c = tregistry.ExecContext(kind="mlp", platform="cuda", schedule="fused",
                              m=1024, d_model=3072, d_ff=8192, gated=True,
                              target=thw.H100)
    assert tregistry.find("mlp", c).name == "cuda_fused_mlp"
