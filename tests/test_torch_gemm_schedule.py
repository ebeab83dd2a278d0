"""The GEMM kernels' schedule (``repro_torch.kernels.gemm``), on the CPU.

``gemm`` and ``gemm_act`` launch what :func:`gemm.schedule` picks from
shape and alignment alone: the TMA + wgmma route where a TMA tensor map
takes the operands (:func:`gemm.tma_ok`), else the mma.sync loop; on the
TMA route the tile width, the split along K, the persistent grid and the
fp32 workspace.  These tests hold that choice at the served shapes and at
edge cases, on an H100's 132 SMs unless said otherwise.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest

pytest.importorskip("torch")

from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.kernels import gemm, gemm_act  # noqa: E402

SMS = gemm.H100_SMS

# (m, k, n): the served and measured shapes (PERF.md's table) and edges
SHAPES = [
    (1024, 3072, 3072), (1024, 3072, 1024),          # llama3.2-3b
    (4096, 4096, 4096), (4096, 4096, 256),           # recurrentgemma-9b
    (2048, 24576, 6144), (128, 24576, 6144),         # granite down
    (256, 24576, 6144), (512, 24576, 6144), (1024, 24576, 6144),
    (2048, 6144, 24576), (128, 6144, 24576),         # granite up
    (256, 6144, 24576), (512, 6144, 24576), (1024, 6144, 24576),
    (2048, 6144, 6144), (2048, 6144, 128),           # granite projections
    (3072, 768, 3072),                               # ViT-B, the paper's op
    (130, 3000, 136), (1100, 640, 6136), (200, 256, 512), (7, 40, 24),
    (1, 8, 8), (128, 64, 128), (70, 64, 136), (5000, 8, 8),
]


def _tiles(m, n, bn):
    return -(-m // gemm.BLOCK_M) * -(-n // bn)


@pytest.mark.parametrize("k,n,ptrs,want", [
    (3072, 1024, (0, 256), True),
    (40, 24, (16, 32), True),
    (8, 8, (0, 0), True),
    (1003, 3005, (0, 0), False),     # K and N odd: the ragged case
    (3000, 129, (0, 0), False),      # N not a multiple of 8
    (33, 16, (0, 0), False),         # K not a multiple of 8
    (64, 136, (2, 0), False),        # a view one element into x
    (64, 136, (0, 18), False),       # ... or into w
    (64, 136, (8, 16), False),       # 8-byte aligned is not enough
    (0, 8, (0, 0), False),           # K = 0: no tensor map
])
def test_tma_takes_only_aligned_rows_of_whole_chunks(k, n, ptrs, want):
    assert gemm.tma_ok(k, n, *ptrs) is want


@pytest.mark.parametrize("m,k,n", [(1001, 1003, 3005), (5, 33, 17),
                                   (130, 3000, 129), (70, 64, 136)])
def test_mma_sync_route_is_one_block_a_tile(m, k, n):
    s = gemm.schedule(m, n, k, tma=False)
    assert (s.route, s.label, s.block_n, s.split_k) == (
        "mma.sync", "mma.sync", 128, 1)
    assert s.grid == _tiles(m, n, 128) and s.workspace_bytes == 0


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_k_is_one_once_the_tiles_fill_the_sms(m, k, n):
    s = gemm.schedule(m, n, k)
    assert s.route == "tma" and s.block_n in gemm.BLOCK_N
    if _tiles(m, n, s.block_n) >= SMS:
        assert s.split_k == 1 and s.label == "tma"


@pytest.mark.parametrize("m,k,n,split", [
    (2048, 6144, 128, 6),      # granite's MQA wk/wv: 16 tiles
    (128, 24576, 6144, 5),     # granite's down projection, M = 128
    (4096, 4096, 256, 2),      # recurrentgemma's wk/wv: 32 or 64 tiles
    (1024, 3072, 1024, 2),     # llama's wo at M = 1024
    (130, 3000, 136, 10),      # 4 tiles, ragged
])
def test_split_k_where_the_tiles_leave_sms_idle(m, k, n, split):
    s = gemm.schedule(m, n, k)
    assert _tiles(m, n, s.block_n) < SMS
    assert s.split_k == split and s.label == f"tma+splitk={split}"


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_k_ranges_are_non_empty_and_cover_k(m, k, n):
    s = gemm.schedule(m, n, k)
    ranges = gemm.k_ranges(k, s.split_k)
    assert len(ranges) == s.split_k
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for a0, a1 in ranges:
        assert a0 < a1 and a0 % gemm.BLOCK_K == 0
        # each range holds at least MIN_SPLIT_STEPS k steps when split
        if s.split_k > 1:
            assert -(-(a1 - a0) // gemm.BLOCK_K) >= gemm.MIN_SPLIT_STEPS


@pytest.mark.parametrize("k,split", [(64, 1), (8, 1), (520, 2), (3000, 10),
                                     (6144, 6), (24576, 5), (4096, 16)])
def test_k_ranges_at_edge_splits(k, split):
    ranges = gemm.k_ranges(k, split)
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_workspace_holds_the_fp32_partials(m, k, n):
    s = gemm.schedule(m, n, k)
    want = s.split_k * m * n * 4 if s.split_k > 1 else 0
    assert s.workspace_bytes == want


@pytest.mark.parametrize("sms", [SMS, 114, 8])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_persistent_grid_is_at_most_one_block_an_sm(m, k, n, sms):
    s = gemm.schedule(m, n, k, sms=sms)
    units = _tiles(m, n, s.block_n) * s.split_k
    assert 1 <= s.grid <= min(sms, units)


@pytest.mark.parametrize("m,k,n,label,block_n", [
    (2048, 1024, 6144, "tma", 256),              # full 128 x 256 tiles
    (3072, 768, 3072, "tma", 128),               # ViT-B: 576 tiles
    (1100, 640, 6136, "tma", 256),               # ragged M and N
    (2048, 24576, 6144, "tma", 256),
    (2048, 6144, 24576, "tma", 256),
    (128, 6144, 24576, "tma", 256),
])
def test_schedule_at_the_card_tests_shapes(m, k, n, label, block_n):
    s = gemm.schedule(m, n, k)
    assert (s.label, s.block_n) == (label, block_n)


@pytest.mark.parametrize("block_n", gemm.BLOCK_N)
def test_a_tile_width_can_be_asked_for(block_n):
    s = gemm.schedule(3072, 3072, 768, block_n=block_n)
    assert s.block_n == block_n and s.route == "tma"


def test_the_ring_fits_the_cards_shared_memory():
    cap = thw.H100.fast.capacity_bytes
    assert cap == 232_448
    assert gemm.SMEM_BYTES == 192 * 1024 + 256 + 1024 <= cap
    assert gemm_act.SMEM_BYTES == gemm.SMEM_BYTES
