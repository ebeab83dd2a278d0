"""The chunkwise mLSTM kernel's schedule (``repro_torch.kernels.mlstm``),
on the CPU.

``mlstm_scan`` launches what :func:`mlstm.schedule` picks from the shape
alone: chunks of 64 steps, the 64-row tiles of Cᵀ its four owner
warpgroups hold, the Q/K ring's depth, the scan's grid (32 columns of
one head's C a block), the ``Q Kᵀ`` kernel's blocks, both footprints and
the fp32 ``Q Kᵀ`` scratch passed between the two kernels.  These tests
hold it at xlstm-1.3b's served shapes (B·H = 4, Dh = 1024, every prefill
bucket from 128 to 2048) and at every head dim the kernel takes.  The
kernel runs only on the card (``tests/test_torch_cuda.py``), which also
checks the footprints against the CUDA launcher's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mlstm  # noqa: E402

HEAD_DIMS = list(range(32, mlstm.MAX_HEAD_DIM + 1, 32))
BUCKETS = [128, 256, 512, 1024, 2048]


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_every_footprint_fits_a_block(dh):
    s = mlstm.schedule(1, 4, 2048, dh)
    assert s.smem_bytes <= mlstm.SMEM_LIMIT == 232_448
    assert s.qk_smem_bytes <= mlstm.SMEM_LIMIT
    assert s.smem_bytes == mlstm.smem_bytes_for(s.stages)


def test_the_ring_is_as_deep_as_shared_memory_allows():
    """The deepest multiple of the four owner warpgroups that fits (an
    owner's parity wait is sound only when each slot holds one owner's
    tiles; see ``stages_for``), beside two chunk buffers."""
    stages = mlstm.stages_for()
    assert stages % mlstm.OWNERS == 0 and stages >= mlstm.OWNERS
    assert stages == 4 == mlstm.BWD_STATE_STAGES
    assert mlstm.CHUNK_BUFFERS == 2
    assert mlstm.smem_bytes_for(stages) <= mlstm.SMEM_LIMIT
    assert mlstm.smem_bytes_for(stages + mlstm.OWNERS) > mlstm.SMEM_LIMIT


def test_each_ring_slot_serves_one_owner():
    """Tile nt of a chunk's round belongs to owner nt mod 4 (every
    fourth tile, ``dk_tiles`` a multiple of four), and the ring's slot of
    tile nt is nt mod stages: at the chosen depth every slot holds one
    owner's tiles only, at six (a depth that fits) slots change owner."""
    s = mlstm.schedule(1, 4, 256, 1024)
    tiles = s.n_chunks * s.dk_tiles
    owner = {}
    for c in range(s.n_chunks):
        for w in range(mlstm.OWNERS):
            for i in range(s.tiles_per_owner):
                owner[c * s.dk_tiles + w + mlstm.OWNERS * i] = w
    assert sorted(owner) == list(range(tiles))

    def owners_of_slots(stages):
        slots = {}
        for nt, w in owner.items():
            slots.setdefault(nt % stages, set()).add(w)
        return slots

    assert all(len(w) == 1 for w in owners_of_slots(s.stages).values())
    assert mlstm.smem_bytes_for(6) <= mlstm.SMEM_LIMIT
    assert any(len(w) > 1 for w in owners_of_slots(6).values())


@pytest.mark.parametrize("t", BUCKETS)
@pytest.mark.parametrize("b,h", [(1, 4), (4, 4)])
def test_grid_at_the_served_shapes(b, h, t):
    """xlstm-1.3b: 4 heads of Dh = 1024; one slot's prefill (B = 1) and
    four slots: one block per 32 columns of a head's C, chunks of 64."""
    s = mlstm.schedule(b, h, t, 1024)
    assert s.chunk == 64 and s.n_chunks == t // 64
    assert s.grid == (32, b * h)
    assert s.qk_grid == s.n_chunks * b * h
    assert (s.dk_tiles, s.tiles_per_owner) == (16, 4)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 437, 2048])
def test_chunks_cover_t_and_the_scratch_holds_one_q_kt_each(t):
    s = mlstm.schedule(2, 3, t, 128)
    chunk = s.chunk
    assert chunk == mlstm.CHUNK == 64
    assert (s.n_chunks - 1) * chunk < t <= s.n_chunks * chunk
    assert s.qk_grid == s.n_chunks * 6
    assert s.scratch_bytes == 4 * 6 * s.n_chunks * chunk * chunk


def test_scratch_at_the_headline_shape():
    # (1, 4, 2048, 1024): 32 chunks of 64 x 64 fp32 a head, 2 MiB
    assert mlstm.schedule(1, 4, 2048, 1024).scratch_bytes == 2 << 20


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_dk_tiles_cover_the_head_dim_in_whole_owner_rounds(dh):
    n = mlstm.dk_tiles(dh)
    assert n % mlstm.OWNERS == 0 and 64 * n >= dh
    assert 64 * (n - mlstm.OWNERS) < dh
    assert mlstm.schedule(1, 1, 10, dh).tiles_per_owner == n // 4 <= 4


@pytest.mark.parametrize("b,h,t,dh", [
    (1, 4, 64, 48),                # not a multiple of 32
    (1, 4, 64, 1056),              # above 1024
    (1, 4, 64, 0),
    (0, 4, 64, 128),               # no (batch, head) pair
    (1, 4, 0, 128),                # no step
    (65536, 1, 64, 128),           # more (batch, head) pairs than grid.y
])
def test_schedule_refuses_what_the_kernel_does_not_take(b, h, t, dh):
    with pytest.raises(ValueError):
        mlstm.schedule(b, h, t, dh)


def test_label_names_the_chunk_stages_and_grids():
    assert mlstm.schedule(1, 4, 2048, 1024).label == \
        "L=64, 4 stages, grid 32x4 + qk 128"
