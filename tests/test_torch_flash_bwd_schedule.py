"""The flash-attention backward's schedule (``repro_torch.kernels.
flash_attention.bwd_schedule``), on the CPU.

``flash_attention_bwd`` launches what :func:`flash_attention.bwd_schedule`
picks from the shape alone: the dK/dV kernel's key tile (128 keys, 64 at
head_dim 256), its ring, the splits
of a group's q heads and its grid; the dQ kernel's query tile, ring and
grid; each kernel's shared memory and its tiles' launch order, heaviest
first.  The dK/dV kernel splits each key tile's loop into query tiles it
masks and tiles it does not as :func:`flash_attention.query_tiles` does.
These tests hold both at the served shapes and at edges, the split
against a brute-force mask, on an H100's 132 SMs unless said otherwise.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (b, hq, hk, tq, tk, dh, causal, window, q_offset): the measured shapes
# (chip_smoke.py's backward rows) and edges
SERVED = [
    (2, 24, 8, 1024, 1024, 128, True, None, 0),     # llama3.2-3b, train
    (1, 24, 8, 2048, 2048, 128, True, None, 0),
    (1, 48, 1, 2048, 2048, 128, True, None, 0),     # granite-20b
    (2, 24, 8, 1000, 1000, 128, True, None, 0),     # ragged
    (1, 8, 8, 448, 1500, 64, False, None, 0),       # whisper-base cross
    (1, 24, 8, 2048, 2048, 128, True, 512, 0),
    (1, 16, 1, 3072, 3072, 256, True, 2048, 0),     # recurrentgemma, train
    (1, 16, 1, 4096, 4096, 256, True, 2048, 0),
    (1, 16, 1, 1024, 1024, 256, True, None, 0),
    (1, 16, 1, 1000, 1000, 256, True, 256, 0),
]
EDGES = [
    (1, 2, 2, 64, 64, 64, True, None, 0),           # a key tile past Tk
    (2, 4, 1, 70, 130, 64, True, 16, 60),           # MQA, window, offset
    (1, 8, 8, 100, 150, 64, False, None, 0),        # Tq != Tk
    (1, 2, 2, 8, 8, 64, True, 2, 20),               # every row masked
    (2, 4, 1, 130, 130, 256, True, None, 0),
    (1, 24, 8, 600, 600, 128, True, 100, 0),        # GQA, window
    (1, 2, 1, 130, 600, 128, True, 129, 450),       # offset, Tq != Tk
    (1, 2, 1, 1000, 1000, 128, False, 300, 0),      # window, not causal
    (1, 2, 2, 300, 333, 128, False, None, 0),       # ragged Tq and Tk
    (1, 4, 4, 256, 64, 128, True, 3, 0),            # Tq > Tk + window
    (3, 1, 1, 1, 5000, 256, True, None, 4999),      # one decode-like row
]
CASES = SERVED + EDGES


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


def _sched(case, **kw):
    return fa.bwd_schedule(*case, **kw)


@pytest.mark.parametrize("case,block_k,splits,block_q", [
    (SERVED[0], 128, 3, 128),   # 8 key tiles x 8 x 2 = 128 < 132: split 3
    (SERVED[2], 128, 12, 128),  # 16 key tiles x 1: 12 of 48 q heads
    (SERVED[4], 128, 1, 64),    # 12 x 8 = 96, one q head a kv head
    (SERVED[6], 64, 4, 64),     # head_dim 256: 48 x 4 = 192
    (SERVED[9], 64, 16, 64),    # 16 tiles: the whole group
    (EDGES[5], 128, 3, 128),    # 5 x 8 x 3 = 120: the whole group
])
def test_tiles_at_the_measured_shapes(case, block_k, splits, block_q):
    s = _sched(case)
    assert (s.block_k, s.splits, s.block_q) == (block_k, splits, block_q)


@pytest.mark.parametrize("case", CASES)
def test_each_head_dim_has_one_tile_a_kernel(case):
    """The tiles follow the head dim alone: dK/dV in rows of 128 keys
    below 256 and in columns of 64 keys at 256; dQ 128 rows at 128, 64 at
    64 and 256."""
    dh = case[5]
    s = _sched(case)
    assert s.block_k == fa.BWD_BLOCK_K[dh] == (64 if dh == 256 else 128)
    assert s.block_q == fa.BWD_BLOCK_Q[dh] == (128 if dh == 128 else 64)


@pytest.mark.parametrize("case", CASES)
def test_grids(case):
    """dK/dV: one block per (key tile, kv head, batch, split); dQ: one per
    (query tile, q head, batch); each order lists its tiles."""
    b, hq, hk, tq, tk = case[:5]
    s = _sched(case)
    assert len(s.kv_order) == -(-tk // s.block_k)
    assert len(s.q_order) == -(-tq // s.block_q)
    assert s.kv_grid == len(s.kv_order) * hk * b * s.splits
    assert s.q_grid == len(s.q_order) * hq * b
    assert (hq // hk) % s.splits == 0


@pytest.mark.parametrize("case", CASES)
def test_splits_are_the_fewest_that_fill_the_card(case):
    """The fewest divisor of the group whose dK/dV grid reaches the SMs at
    the schedule's key tile, else the whole group."""
    b, hq, hk, tq, tk = case[:5]
    s = _sched(case)
    group = hq // hk
    blocks = -(-tk // s.block_k) * hk * b
    assert s.splits == fa.bwd_splits(b, hq, hk, tk, s.block_k, fa.H100_SMS)
    assert blocks * s.splits >= fa.H100_SMS or s.splits == group
    assert all(blocks * d < fa.H100_SMS
               for d in range(1, s.splits) if group % d == 0)


def _footprint(kernel, dh, tile, stages):
    # csrc/flash_attention_bwd.cu: KvCfg / QCfg::smem_bytes
    if kernel == "dkdv":
        trade = 32768 if tile == 64 else 0
        return (1024 + 2 * tile * dh * 2
                + stages * (2 * 64 * dh * 2 + 512) + trade + 256)
    trade = 32768 if dh == 256 else 0
    return 1024 + 2 * tile * dh * 2 + 2 * stages * 64 * dh * 2 + trade + 256


@pytest.mark.parametrize("kernel,tiles", [("dkdv", fa.BWD_BLOCK_K),
                                          ("dq", fa.BWD_BLOCK_Q)])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_every_footprint_fits_a_block(kernel, tiles, dh):
    """Each ring is as deep as a block's shared memory allows (one stage
    more would not fit, or the kernel holds no more), at least 2."""
    tile = tiles[dh]
    st = fa.bwd_stages_for(kernel, dh, tile)
    n = fa.bwd_smem_bytes(kernel, dh, tile, st)
    assert n == _footprint(kernel, dh, tile, st)
    assert n <= fa.SMEM_LIMIT == thw.H100.fast.capacity_bytes
    assert 2 <= st <= fa.MAX_STAGES
    assert st == fa.MAX_STAGES or \
        _footprint(kernel, dh, tile, st + 1) > fa.SMEM_LIMIT


def test_served_footprints():
    # dK/dV at D = 128, 128 keys: K and V 64 KB + 4 stages of Q and dO
    # (32 KB) and their lse and D rows; at D = 256, 64 keys: K and V 64 KB,
    # 2 stages of 64 KB, the 32 KB trade.  dQ at D = 128, 128 rows: Q and
    # dO 64 KB + 4 stages of K and V of 64 keys (32 KB); at D = 256: 64 KB
    # + 2 stages of 64 KB + the trade.  Each with 1 KB of alignment slack
    # and 256 B of barriers.
    assert fa.bwd_smem_bytes("dkdv", 128, 128, 4) == \
        1024 + 65536 + 4 * 33280 + 256
    assert fa.bwd_smem_bytes("dkdv", 256, 64, 2) == \
        1024 + 65536 + 2 * 66048 + 32768 + 256
    assert fa.bwd_smem_bytes("dq", 128, 128, 4) == \
        1024 + 65536 + 4 * 32768 + 256
    assert fa.bwd_smem_bytes("dq", 256, 64, 2) == \
        1024 + 65536 + 2 * 65536 + 32768 + 256
    s = _sched(SERVED[0])
    assert (s.kv_stages, s.q_stages) == (4, 4)
    assert (s.kv_smem_bytes, s.q_smem_bytes) == (199_936, 197_888)
    s = _sched(SERVED[6])
    assert (s.kv_stages, s.q_stages) == (2, 2)
    assert (s.kv_smem_bytes, s.q_smem_bytes) == (231_680, 230_656)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_query_split_matches_a_brute_force_mask(case, block_k):
    """Every query tile outside [lo, hi) sees no key of the key tile; every
    tile in it sees some; the tiles run without a mask are seen whole by
    every real row, in a key tile holding no key past Tk; and every other
    tile of the span is not (the split is tight)."""
    tq, tk = case[3], case[4]
    vis = _visible(case)
    for j in range(-(-tk // block_k)):
        cols = vis[:, j * block_k:(j + 1) * block_k]
        sp = fa.query_tiles(j, block_k, fa.BWD_ROWS, tq, tk, *case[6:])
        assert 0 <= sp.lo <= sp.full_lo <= sp.full_hi <= sp.hi
        for i in range(-(-tq // fa.BWD_ROWS)):
            blk = cols[i * fa.BWD_ROWS:(i + 1) * fa.BWD_ROWS]
            whole = blk.shape[1] == block_k and bool(blk.all())
            if i < sp.lo or i >= sp.hi:
                assert not blk.any(), (j, i)
            else:
                assert blk.any(), (j, i)
                assert whole == (sp.full_lo <= i < sp.full_hi), (j, i)
        if not cols.any():
            assert sp.tiles == 0


@pytest.mark.parametrize("case", CASES)
def test_query_split_is_the_transpose_of_the_key_split(case):
    """A (query tile, key tile) pair runs unmasked in the dK/dV kernel
    exactly where it does in a key loop over the same tiles."""
    tq, tk = case[3], case[4]
    rows = fa.BWD_ROWS
    for block_k in (64, 128):
        qs = [fa.query_tiles(j, block_k, rows, tq, tk, *case[6:])
              for j in range(-(-tk // block_k))]
        for i in range(-(-tq // rows)):
            ks = fa.key_tiles(i, rows, block_k, tq, tk, *case[6:])
            for j, q in enumerate(qs):
                seen_k, seen_q = ks.lo <= j < ks.hi, q.lo <= i < q.hi
                assert seen_k == seen_q, (i, j)
                if seen_k:
                    assert (ks.full_lo <= j < ks.full_hi) == \
                        (q.full_lo <= i < q.full_hi), (i, j)


def _seen(vis, rows, cols, r):
    """Tiles of ``cols`` columns that row tile ``r`` (``rows`` rows) of
    vis sees."""
    n = -(-vis.shape[1] // cols)
    return sum(bool(vis[r * rows:(r + 1) * rows, j * cols:(j + 1) * cols]
                    .any()) for j in range(n))


@pytest.mark.parametrize("case", CASES)
def test_launch_orders_are_heaviest_first(case):
    """Each order lists every tile once, and the tiles of the other axis
    each one loops over (from the brute-force mask) do not increase along
    it: key tiles by the 64-query tiles they see, query tiles by the
    64-key tiles theirs see."""
    s = _sched(case)
    vis = _visible(case)
    assert sorted(s.kv_order) == list(range(len(s.kv_order)))
    assert sorted(s.q_order) == list(range(len(s.q_order)))
    kv = [_seen(vis.T, s.block_k, fa.BWD_ROWS, j) for j in s.kv_order]
    q = [_seen(vis, s.block_q, fa.BWD_ROWS, i) for i in s.q_order]
    assert kv == sorted(kv, reverse=True)
    assert q == sorted(q, reverse=True)


def test_causal_orders_put_the_longest_loops_first():
    s = _sched(SERVED[0])
    assert s.kv_order == tuple(range(8))           # key tile 0 sees all
    assert s.q_order == tuple(range(7, -1, -1))    # the last query tile


@pytest.mark.parametrize("bad", [
    dict(dh=32),
    dict(hk=3),
    dict(hk=0),
    dict(tq=0),
    dict(tk=0),
    dict(tq=fa.MAX_TILES * 128 + 1),
    dict(tk=fa.MAX_TILES * 128 + 1),
    dict(dh=256, tk=fa.MAX_TILES * 64 + 1),   # 64-key tiles at D = 256
])
def test_schedule_refuses_what_the_kernels_do_not_take(bad):
    kw = dict(b=1, hq=4, hk=2, tq=100, tk=100, dh=128, causal=True,
              window=None, q_offset=0)
    kw.update(bad)
    with pytest.raises(ValueError):
        fa.bwd_schedule(kw.pop("b"), kw.pop("hq"), kw.pop("hk"),
                        kw.pop("tq"), kw.pop("tk"), kw.pop("dh"),
                        kw.pop("causal"), kw.pop("window"),
                        kw.pop("q_offset"), **kw)


def test_splits_take_the_key_tile():
    """The splits are counted at the key tile the caller names: llama's
    train path needs 3 at 128 keys and would need none at 64."""
    with pytest.raises(TypeError):
        fa.bwd_splits(2, 24, 8, 1024)
    assert fa.bwd_splits(2, 24, 8, 1024, 128) == 3
    assert fa.bwd_splits(2, 24, 8, 1024, 64) == 1


def test_only_tma_and_wgmma_do_the_products():
    """The backward's source holds no warp-level mma.sync, ldmatrix or
    cp.async path: its products are wgmma on TMA-loaded tiles."""
    from pathlib import Path
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    for old in ("mma16816", "ldmatrix", "load_a(", "cp_async"):
        assert old not in src, old
    for part in ("Wgmma<64, 0>::ss", "::rs(", "tma_load_3d", "mbar_wait"):
        assert part in src, part
