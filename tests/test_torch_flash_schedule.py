"""The flash-attention kernel's schedule (``repro_torch.kernels.
flash_attention``), on the CPU.

``flash_attention`` launches what :func:`flash_attention.schedule` picks
from the shape alone: the query tile height (128, or 64 where 128 would
leave SMs idle), the key tile width, the ring's stages, the grid, the
shared memory and the query tiles' launch order, heaviest first; the
kernel splits each tile's key loop into tiles it masks and tiles it does
not as :func:`flash_attention.key_tiles` does.  These tests hold both at
the served shapes and at edges, the split against a brute-force mask, on
an H100's 132 SMs unless said otherwise.  The kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core.ftl import registry as tregistry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (b, hq, hk, tq, tk, dh, causal, window, q_offset): the served and
# measured shapes (PERF.md's table) and edges
SERVED = [
    (1, 24, 8, 200, 200, 128, True, None, 0),       # llama3.2-3b
    (1, 24, 8, 1024, 1024, 128, True, None, 0),
    (1, 48, 1, 2048, 2048, 128, True, None, 0),     # granite-20b
    (1, 16, 1, 1024, 1024, 256, True, 2048, 0),     # recurrentgemma-9b
    (1, 16, 1, 4096, 4096, 256, True, 2048, 0),
    (1, 8, 8, 448, 1500, 64, False, None, 0),       # whisper-base cross
]
EDGES = [
    (2, 4, 2, 70, 100, 128, True, 16, 30),
    (1, 2, 2, 8, 8, 64, True, 2, 20),               # every row masked
    (1, 16, 1, 700, 700, 256, True, 200, 0),
    (2, 4, 1, 50, 90, 256, True, 16, 40),
    (2, 4, 2, 300, 333, 128, False, None, 0),       # ragged Tq and Tk
    (1, 4, 4, 333, 300, 128, True, 100, 0),         # window inside a tile
    (1, 2, 1, 130, 600, 64, True, 129, 450),        # q_offset, Tq != Tk
    (1, 2, 1, 1000, 1000, 128, False, 300, 0),      # window, not causal
    (3, 1, 1, 1, 5000, 256, True, None, 4999),      # one decode-like row
]
CASES = SERVED + EDGES
# a causal window with more queries than keys: the last key a tile's
# rows all see can lie past every key tile (at Tq 128, Tk 16, window 2
# the forward once sent its masked loop to a tile it never loaded)
WINDOWED = [(1, 2, 1, tq, tk, dh, True, win, 0)
            for tq in (64, 128, 200, 256) for tk in (16, 64, 100)
            if tq > tk for win in (2, 17, 50) for dh in (128, 256)]


def _sched(case, **kw):
    return fa.schedule(*case, **kw)


@pytest.mark.parametrize("case,block_q", [
    (SERVED[0], 64),     # 2 tiles x 24 heads = 48 blocks < 132
    (SERVED[1], 128),    # 8 x 24 = 192
    (SERVED[2], 128),    # 16 x 48 = 768
    (SERVED[3], 64),     # 8 x 16 = 128 < 132
    (SERVED[4], 128),    # 32 x 16 = 512
    (SERVED[5], 64),     # 4 x 8 = 32
])
def test_tile_height_at_the_served_shapes(case, block_q):
    assert _sched(case).block_q == block_q


@pytest.mark.parametrize("case", CASES)
def test_tile_height_is_the_taller_unless_it_leaves_sms_idle(case):
    b, hq, _, tq = case[:4]
    s = _sched(case)
    tall = -(-tq // 128) * hq * b
    assert s.block_q == (128 if tall >= fa.H100_SMS else 64)
    assert _sched(case, sms=8).block_q == 128 or tall < 8


@pytest.mark.parametrize("case", CASES)
def test_grid_is_one_block_a_query_tile_head_and_batch(case):
    b, hq, _, tq = case[:4]
    s = _sched(case)
    assert len(s.order) == -(-tq // s.block_q)
    assert s.grid == len(s.order) * hq * b


@pytest.mark.parametrize("dh,bk,stages", [
    (64, 128, {128: 4, 64: 4}), (128, 128, {128: 3, 64: 3}),
    (256, 64, {128: 2, 64: 3})])
def test_key_tile_width_and_ring(dh, bk, stages):
    assert fa.block_kv(dh) == bk
    for block_q in fa.BLOCK_Q:
        s = fa.schedule(1, 4, 4, 1000, 1000, dh, True, None, 0,
                        block_q=block_q)
        assert (s.block_k, s.stages) == (bk, stages[block_q])
        assert 2 <= s.stages <= fa.MAX_STAGES


def _footprint(dh, block_q, stages):
    return (1024 + block_q * dh * 2
            + 2 * stages * fa.block_kv(dh) * dh * 2 + 256)


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("block_q", fa.BLOCK_Q)
def test_every_footprint_fits_a_block(dh, block_q):
    """The ring is as deep as a block's shared memory allows: one stage
    more would not fit (or the kernel holds no more)."""
    st = fa.stages_for(dh, block_q)
    n = fa.smem_bytes_for(dh, block_q)
    assert n == _footprint(dh, block_q, st)
    assert n <= fa.SMEM_LIMIT == thw.H100.fast.capacity_bytes == 232_448
    assert st == fa.MAX_STAGES or \
        _footprint(dh, block_q, st + 1) > fa.SMEM_LIMIT
    assert n <= fa.smem_bytes(dh)


def test_served_footprints():
    # D = 128: Q 32 KB + 3 x (K + V) of 128 keys; D = 256: Q 32 KB (64
    # rows) + 3 x (K + V) of 64 keys; D = 64: Q 16 KB + 4 x (K + V) of
    # 128 keys; each with its barriers and alignment slack
    assert fa.smem_bytes(128) == 1024 + 32768 + 196608 + 256
    assert fa.smem_bytes(256) == 1024 + 32768 + 196608 + 256
    assert fa.smem_bytes(64) == 1024 + 16384 + 131072 + 256


@pytest.mark.parametrize("case", CASES)
def test_schedule_footprint_is_its_tile_heights(case):
    s = _sched(case)
    assert s.smem_bytes == fa.smem_bytes_for(case[5], s.block_q)


@pytest.mark.parametrize("dh", [128, 256])
def test_the_registry_binds_the_kernel_on_h100(dh):
    c = tregistry.ExecContext(kind="attention", platform="cuda",
                              schedule="fused", m=1024, d_model=4096,
                              d_ff=8192, target=thw.H100, head_dim=dh)
    assert tregistry.find("attention", c).name == "cuda_flash_attention"


def _visible(case):
    """The brute-force mask (tq, tk): which keys each real row sees."""
    _, _, _, tq, tk, _, causal, window, q_offset = case
    qpos = torch.arange(tq)[:, None] + q_offset
    kpos = torch.arange(tk)[None, :]
    vis = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    return vis


@pytest.mark.parametrize("block_q", fa.BLOCK_Q)
@pytest.mark.parametrize("case", CASES + WINDOWED)
def test_key_split_matches_a_brute_force_mask(case, block_q):
    """Every tile outside [lo, hi) is hidden from every row; every tile in
    it is seen by some row; the tiles run without a mask are seen whole by
    every real row and hold no key past Tk; and every other tile of the
    span is not (the split is tight)."""
    tq, tk, dh = case[3], case[4], case[5]
    bk = fa.block_kv(dh)
    vis = _visible(case)
    for i in range(-(-tq // block_q)):
        rows = vis[i * block_q:(i + 1) * block_q]
        sp = fa.key_tiles(i, block_q, bk, tq, tk, *case[6:])
        assert 0 <= sp.lo <= sp.full_lo <= sp.full_hi <= sp.hi
        for j in range(-(-tk // bk)):
            blk = rows[:, j * bk:(j + 1) * bk]
            whole = blk.shape[1] == bk and bool(blk.all())
            if j < sp.lo or j >= sp.hi:
                assert not blk.any(), (i, j)
            else:
                assert blk.any(), (i, j)
                assert whole == (sp.full_lo <= j < sp.full_hi), (i, j)
        if not rows.any():
            assert sp.tiles == 0


@pytest.mark.parametrize("block_q", fa.BLOCK_Q)
@pytest.mark.parametrize("case", CASES)
def test_launch_order_is_heaviest_first(case, block_q):
    """The order lists every query tile once, and the key tiles each one
    loops over (from the brute-force mask) do not increase along it."""
    s = _sched(case, block_q=block_q)
    n = -(-case[3] // block_q)
    assert sorted(s.order) == list(range(n))
    bk = fa.block_kv(case[5])
    vis = _visible(case)
    cols = -(-case[4] // bk)
    spans = []
    for i in s.order:
        seen = [bool(vis[i * block_q:(i + 1) * block_q,
                         j * bk:(j + 1) * bk].any()) for j in range(cols)]
        spans.append(sum(seen))
    assert spans == sorted(spans, reverse=True)


def test_causal_order_puts_the_last_tiles_first():
    s = fa.schedule(1, 48, 1, 2048, 2048, 128, True, None, 0)
    assert s.order == tuple(range(15, -1, -1))


@pytest.mark.parametrize("bad,exc", [
    (dict(dh=32), ValueError),
    (dict(hk=3), ValueError),
    (dict(block_q=32), ValueError),
    (dict(tq=fa.MAX_TILES * 128 + 1), ValueError),
])
def test_schedule_refuses_what_the_kernel_does_not_take(bad, exc):
    kw = dict(b=1, hq=4, hk=2, tq=100, tk=100, dh=128, causal=True,
              window=None, q_offset=0)
    kw.update(bad)
    with pytest.raises(exc):
        fa.schedule(kw.pop("b"), kw.pop("hq"), kw.pop("hk"), kw.pop("tq"),
                    kw.pop("tk"), kw.pop("dh"), kw.pop("causal"),
                    kw.pop("window"), kw.pop("q_offset"), **kw)
