"""The RG-LRU kernel's schedule (``repro_torch.kernels.rg_lru``), on the
CPU.

``rg_lru_scan`` launches what :func:`rg_lru.schedule` picks from the
shape alone: the channel tile and chunk length of a block, its warps
(compute warps of 8 channels x 16 steps a thread, a fold warp per 32
channels, a publisher warp), the grid (one block a batch row, chunk and
tile), a block's shared memory, the unit aggregates' scratch and the sync
buffer's words.  These tests hold it at recurrentgemma-9b's served shapes
(W = 4096, every prefill bucket from 128 to 4096, one slot and four) and
at every tile and chunk the kernel takes.  The kernel runs only on the
card (``tests/test_torch_cuda.py``), which also checks the footprints
against the CUDA launcher's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rg_lru  # noqa: E402
from repro_torch.models.model import PREFILL_BUCKETS  # noqa: E402

SERVED = [t for t in PREFILL_BUCKETS if t >= 128]
CHUNKS = list(range(rg_lru.UNIT, rg_lru.MAX_CHUNK + 1, rg_lru.UNIT))


def test_the_served_buckets_run_from_128_to_4096():
    assert SERVED == [128, 256, 512, 1024, 2048, 4096]
    assert rg_lru.MIN_BLOCKS == 2 * 132


@pytest.mark.parametrize("t", SERVED)
@pytest.mark.parametrize("b", [1, 4])
def test_the_grid_fills_the_card_at_every_served_bucket(b, t):
    """recurrentgemma-9b's lru_width 4096: at least two blocks an SM of
    an H100 at every bucket, one slot's prefill and four."""
    s = rg_lru.schedule(b, t, 4096)
    assert s.grid == b * s.n_chunks * s.n_tiles >= rg_lru.MIN_BLOCKS
    assert (s.channel_tile, s.chunk) in rg_lru.LADDER


def test_the_headline_schedule():
    """(1, 4096, 4096): 64-channel tiles, 256-step chunks, 1024 blocks of
    four compute warps, two fold warps and a publisher; 15 chunks publish
    four units each."""
    s = rg_lru.schedule(1, 4096, 4096)
    assert (s.channel_tile, s.chunk, s.n_chunks, s.n_tiles) == (64, 256,
                                                                16, 64)
    assert (s.grid, s.threads, s.warps) == (1024, 224, 7)
    assert s.smem_bytes == 128 + 65_536 + 8_192 + 2_048 + 256
    assert s.scratch_bytes == 8 * 15 * 4 * 4096
    assert s.sync_words == rg_lru.SYNC_HEADER + 1024


@pytest.mark.parametrize("b,t,w", [(1, 128, 4096), (1, 512, 4096),
                                   (4, 1024, 4096), (2, 1000, 4000),
                                   (1, 1, 8), (3, 131, 13), (2, 200, 256)])
def test_scratch_bytes_match_the_models_published_units(b, t, w):
    """Every chunk but the last publishes its units (a fp32 pair a
    channel): the first ``(n_chunks - 1) · chunk / 64`` of the model's."""
    s = rg_lru.schedule(b, t, w)
    x = torch.zeros((b, t, w))
    (_, _), (uA, uX) = rg_lru.aggregates(x, torch.ones_like(x), sched=s)
    published = (s.n_chunks - 1) * s.chunk // rg_lru.UNIT
    assert published <= uA.shape[1] == -(-t // rg_lru.UNIT)
    assert s.scratch_bytes == 4 * (uA[:, :published].numel()
                                   + uX[:, :published].numel())


@pytest.mark.parametrize("t", [1, 63, 64, 65, 131, 200, 1000, 4096])
@pytest.mark.parametrize("w", [1, 7, 13, 256, 4000, 4100])
def test_chunks_and_tiles_cover_t_and_w(t, w):
    """A ragged T and a ragged W (W % 8 != 0 too) are taken: the last
    chunk and the last tile are cut, never dropped; a chunk is no longer
    than T rounded up to a unit, unless T is shorter than one."""
    s = rg_lru.schedule(2, t, w)
    assert (s.n_chunks - 1) * s.chunk < t <= s.n_chunks * s.chunk
    assert (s.n_tiles - 1) * s.channel_tile < w <= s.n_tiles * s.channel_tile
    assert s.chunk <= max(rg_lru.UNIT, -(-t // rg_lru.UNIT) * rg_lru.UNIT)
    assert s.sync_words == rg_lru.SYNC_HEADER + s.grid


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("ct", rg_lru.CHANNEL_TILES)
def test_every_tile_and_chunk_the_kernel_takes_fits_a_block(ct, chunk):
    """Whole warps, at most 384 threads, the footprint within a block's
    shared memory; a tile and chunk beyond that are refused."""
    threads = rg_lru.threads_for(ct, chunk)
    # compute warps, one fold warp (two past 32 channels), a publisher
    fold = 1 if ct <= 32 else 2
    assert threads == 32 * (-(-rg_lru.compute_threads(ct, chunk) // 32)
                            + fold + 1)
    fits = (threads <= rg_lru.MAX_THREADS
            and rg_lru.smem_bytes(ct, chunk) <= rg_lru.SMEM_LIMIT)
    assert rg_lru.takes(ct, chunk) == fits
    if fits:
        s = rg_lru.schedule(1, 4096, 4096, chunk, ct)
        assert (s.threads, s.smem_bytes) == (threads,
                                             rg_lru.smem_bytes(ct, chunk))
    else:
        with pytest.raises(ValueError):
            rg_lru.schedule(1, 4096, 4096, chunk, ct)


def test_the_footprint_counts_the_tile_the_aggregates_and_the_carry():
    # alignment slack, x and a (bf16), 16 segments and 4 units of fp32
    # pairs, one fp32
    assert rg_lru.smem_bytes(64, 256) == 128 + 4 * 256 * 64 \
        + 16 * 64 * 8 + 4 * 64 * 8 + 64 * 4


@pytest.mark.parametrize("kw", [dict(b=0, t=8, w=8), dict(b=65536, t=8, w=8),
                                dict(b=1, t=0, w=8), dict(b=1, t=8, w=0)])
def test_shapes_the_kernel_cannot_take_are_refused(kw):
    with pytest.raises(ValueError):
        rg_lru.schedule(kw["b"], kw["t"], kw["w"])


@pytest.mark.parametrize("ct,chunk", [(24, 64), (64, 96), (64, 32),
                                      (64, 2048), (128, 512), (64, 1024),
                                      (256, 64)])
def test_tiles_and_chunks_the_kernel_cannot_take_are_refused(ct, chunk):
    assert not rg_lru.takes(ct, chunk)
    with pytest.raises(ValueError):
        rg_lru.schedule(1, 4096, 4096, chunk, ct)


def test_the_largest_batch_is_taken():
    s = rg_lru.schedule(65535, 1, 8)
    assert s.grid == 65535


@pytest.mark.parametrize("b,t,w,want", [
    (1, 4096, 4096, (64, 256)), (1, 2048, 4096, (64, 256)),
    (1, 1024, 4096, (64, 128)), (1, 512, 4096, (64, 64)),
    (1, 256, 4096, (32, 64)), (1, 128, 4096, (16, 64)),
    (4, 1024, 4096, (64, 256)), (2, 1000, 4000, (64, 256)),
    (2, 200, 256, (8, 64))])
def test_the_ladder_takes_the_largest_tile_that_fills_the_card(b, t, w,
                                                                want):
    s = rg_lru.schedule(b, t, w)
    assert (s.channel_tile, s.chunk) == want
    i = rg_lru.LADDER.index(want)
    for ct, ck in rg_lru.LADDER[:i]:
        t_units = -(-t // rg_lru.UNIT) * rg_lru.UNIT
        assert ck > t_units or \
            b * -(-t // ck) * -(-w // ct) < rg_lru.MIN_BLOCKS
