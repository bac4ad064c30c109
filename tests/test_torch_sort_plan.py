"""The sort kernels' narrow-class plans, on the CPU.

Below float32 the sorted-weight kernel gives each thread ``vec_of``
adjacent coordinates read in loads of ``load_width`` bytes, and pairdist
stages tiles of bytes copied in the aligned 16-byte chunks that cover each
row. The kernels run only on the card; their plans are pure Python, held
here at the main paths' shapes and at ragged ends, and the kernels' index
math is modelled here (``thread_spans``, ``staged_chunks``) from the
sources' constants."""

import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.cwtm.cwtm import (VEC_MIN_THREADS_PER_SM,
                                          load_width, n_pad_of, plan_struct,
                                          plan_vec, sorted_weight_threads,
                                          vec_of)
from repro_torch.kernels.median.median import median_weights
from repro_torch.kernels.pairdist.pairdist import (BLOCK_RESERVE,
                                                   NARROW_SMEM_MAX,
                                                   NARROW_THREADS, SM_SMEM,
                                                   SMEM_LIMIT, TILE,
                                                   TILE_BYTES,
                                                   narrow_smem_bytes,
                                                   narrow_tile_bytes,
                                                   pairdist_plan, smem_bytes,
                                                   tile_columns)

H100_SMS = 132
N_PADS = [2, 4, 8, 16, 32, 64]
NARROW = {torch.bfloat16: 2, torch.float16: 2, torch.float8_e4m3fn: 1}
ODD_D = [1, 2, 3, 5, 7, 8, 15, 16, 17, 31, 32, 33, 4099, 11957, 11958,
         20000, 70001]


def thread_spans(d: int, vec: int, threads: int, blocks: int) -> list:
    """The coordinates each thread of a row's ``blocks`` blocks owns in
    ``sorted_weight_pairs_kernel`` (``j0 = (block * threads + thread) *
    V``; a full vector where ``j0 + V <= d``, else the ``d - j0`` left), as
    ``range``s, empty past ``d``."""
    return [range(min(t * vec, d), min(t * vec + vec, d))
            for t in range(blocks * threads)]


def staged_chunks(address: int, col0: int, valid: int, itemsize: int,
                  chunks: int) -> tuple:
    """The ``cp.async`` copies of ``pairdist_narrow_kernel``'s ``issue``
    for one row's ``valid`` columns from column ``col0`` on (the row
    starting at byte ``address``): ``(mis, copies)``, the bytes the first
    column sits past 16 in the stage, and for each of the row's ``chunks``
    16-byte slots with bytes left (``have = mis + bytes - 16 k > 0``)
    ``(stage byte, source address, bytes read)``, the rest of the 16
    zero-filled."""
    src = address + col0 * itemsize
    mis = src % 16
    out = []
    for k in range(chunks):
        have = mis + valid * itemsize - 16 * k
        if have > 0:
            out.append((16 * k, src - mis + 16 * k, min(16, have)))
    return mis, out


def narrow_chunks(tile_bytes: int) -> int:
    """``CHUNKS`` of ``pairdist_narrow_kernel``, read from ``pairdist.cu``:
    the 16-byte slots of a staged row's stride (``narrow_row_bytes``)."""
    src = (build.CSRC / "pairdist.cu").read_text()
    pad = int(re.search(r"narrow_row_bytes\(int tb\) \{ return tb \+ (\d+);",
                        src)[1])
    per = int(re.search(r"CHUNKS = RB / (\d+);", src)[1])
    assert per == 16  # one cp.async of 16 bytes a slot
    return (tile_bytes + pad) // per


@pytest.mark.parametrize("n_pad", N_PADS)
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_coordinates_a_thread_fit_the_registers(n_pad, itemsize):
    v = vec_of(n_pad, itemsize)
    if itemsize == 4:
        assert v == 1  # the float32 class: one coordinate a thread
        return
    assert v >= 2 and v % 2 == 0  # whole pairs
    assert v * itemsize <= 16  # one load of at most 16 bytes a row
    assert v * n_pad // 2 <= 32 or v == 2  # packed pairs: 32 registers
    if n_pad * 16 // itemsize <= 64:
        assert v * itemsize == 16  # a 16-byte load a row


def test_coordinates_a_thread_by_dtype_and_n_pad():
    assert [vec_of(p, 1) for p in N_PADS] == [16, 16, 8, 4, 2, 2]
    assert [vec_of(p, 2) for p in N_PADS] == [8, 8, 8, 4, 2, 2]


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("n", [1, 8, 13, 64])
@pytest.mark.parametrize("d", ODD_D)
def test_load_width_is_the_widest_the_rows_allow(itemsize, n, d):
    v = vec_of(n_pad_of(n), itemsize)
    for address in range(0, 16, itemsize):
        w = load_width(address, d, itemsize, v)
        assert itemsize <= w <= v * itemsize and w & (w - 1) == 0
        assert address % w == 0 and (d * itemsize) % w == 0
        wider = 2 * w
        assert wider > v * itemsize or address % wider or (
            d * itemsize) % wider


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("n", [1, 13, 64])
@pytest.mark.parametrize("d", ODD_D)
@pytest.mark.parametrize("address", [0, 1, 2, 3, 6, 8])
def test_every_coordinate_once_and_no_vector_crosses_a_row(itemsize, n, d,
                                                           address):
    """Each coordinate of a row falls to exactly one thread; a full vector
    lies inside its row, and each of its loads of ``load_width`` bytes sits
    on that width in every row of the batch."""
    if address % itemsize:
        return  # a 16-bit tensor starts on an even byte
    v = vec_of(n_pad_of(n), itemsize)
    w = load_width(address, d, itemsize, v)
    threads = sorted_weight_threads(2, d, H100_SMS, v)
    blocks = -(-(-(-d // v)) // threads)
    spans = thread_spans(d, v, threads, blocks)
    covered = [j for s in spans for j in s]
    assert covered == list(range(d))  # once each, in order
    full = [s for s in spans if len(s) == v]
    assert all(s.start % v == 0 for s in full)  # V * itemsize bytes in
    assert (v * itemsize) % w == 0  # whole W-byte loads a vector
    # every row of the batch starts on W, so every full vector's loads do
    assert all((address + row * d * itemsize) % w == 0
               for row in range(2 * n))
    short = [s for s in spans if 0 < len(s) < v]
    assert all(s.stop == d for s in short) and len(short) <= 1


@pytest.mark.parametrize("shape,itemsize,threads", [
    ((1, 13, 11958), 2, 64), ((1, 13, 11958), 1, 64),
    ((18, 13, 11958), 2, 256), ((36, 13, 11958), 1, 256),
    ((18, 13, 11958), 1, 256), ((1, 13, 1048576), 2, 256),
    ((1, 13, 1048576), 1, 256), ((1, 8, 416179200), 1, 256),
    ((1, 8, 416179200), 2, 256), ((1, 8, 16777216), 1, 256),
    ((1, 8, 20000), 1, 64), ((1, 64, 40000), 2, 128)])
def test_sorted_weight_blocks_at_the_path_shapes(shape, itemsize, threads):
    """The block size counts threads of V coordinates: 256 where that gives
    every SM a block, else the widest that does, else 64."""
    b, n, d = shape
    v = vec_of(n_pad_of(n), itemsize)
    t = sorted_weight_threads(b, d, H100_SMS, v)
    assert t == threads
    blocks = -(-(-(-d // v)) // t) * b
    if t < 256:  # a wider block would leave SMs idle
        assert -(-(-(-d // v)) // (2 * t)) * b < H100_SMS
    if t > 64:
        assert blocks >= H100_SMS


@pytest.mark.parametrize("dtype", list(NARROW))
@pytest.mark.parametrize("address", [0, 1, 2, 8])
@pytest.mark.parametrize("shape,vec", [((1, 13, 11958), 1),
                                       ((36, 13, 11958), 4),
                                       ((1, 13, 1048576), 4),
                                       ((1, 8, 416179200), 8)])
def test_plan_struct_carries_vec_and_width(dtype, address, shape, vec):
    """The vector plan where it gives every SM VEC_MIN_THREADS_PER_SM
    threads (the CNN's single row does not: a coordinate a thread, loads
    of one element), else one coordinate a thread."""
    size = NARROW[dtype]
    if address % size:
        return
    b, n, d = shape
    s = plan_struct(b, n, d, dtype, median_weights(n), H100_SMS, True,
                    address)
    assert s.vec == vec == plan_vec(b, n, d, size, H100_SMS)
    assert vec == 1 or vec == vec_of(n_pad_of(n), size)
    big = -(-d // vec_of(n_pad_of(n), size)) * b
    assert (vec > 1) == (big >= VEC_MIN_THREADS_PER_SM * H100_SMS)
    assert s.width == load_width(address, d, size, s.vec)
    assert s.threads == sorted_weight_threads(b, d, H100_SMS, s.vec)
    assert s.nan_out == 1
    f32 = plan_struct(1, 13, 11958, torch.float32, median_weights(13),
                      H100_SMS)
    assert (f32.vec, f32.width, f32.threads) == (1, 4, 64)


@pytest.mark.parametrize("n", [1, 4, 13, 20, 32, 33, 64])
def test_pairdist_tile_columns_by_itemsize(n):
    assert tile_columns(n, 4) == TILE  # the float32 class keeps its tile
    wide = n_pad_of4(n) <= 32
    # 16 bits: the float32 tile's 1 KB a row (half of it past 32 rows)
    assert narrow_tile_bytes(n, 2) == (TILE_BYTES if wide else TILE_BYTES // 2)
    assert tile_columns(n, 2) == narrow_tile_bytes(n, 2) // 2
    # float8: 512 B a row, whose 16-bit work tile is the 16-bit class's
    assert narrow_tile_bytes(n, 1) == TILE_BYTES // 2
    assert tile_columns(n, 1) == TILE_BYTES // 2
    if wide:  # twice the float32 tile's columns
        assert tile_columns(n, 1) == tile_columns(n, 2) == 2 * TILE


def n_pad_of4(n: int) -> int:
    return -(-n // 4) * 4


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("valid", [1, 2, 3, 15, 16, 17, 511, 512, 1023,
                                   1024])
@pytest.mark.parametrize("address", [0, 1, 2, 3, 5, 8, 14, 15, 16, 4097])
def test_staged_chunks_cover_each_row_once(itemsize, valid, address):
    """The 16-byte chunks that stage a row: aligned sources, the row's
    bytes at its misalignment in the stage, nothing read past its last
    byte (the rest zero-filled), and no more than a row stride of
    ``tile_bytes + 16``."""
    tb = narrow_tile_bytes(13, itemsize)
    if address % itemsize or valid * itemsize > tb:
        return
    col0 = 3 * (tb // itemsize)  # a later tile of the row
    mis, chunks = staged_chunks(address, col0, valid, itemsize,
                                narrow_chunks(tb))
    src = address + col0 * itemsize
    assert mis == src % 16
    assert all(s % 16 == 0 and 0 < r <= 16 for _, s, r in chunks)
    assert [st for st, _, _ in chunks] == list(range(0, 16 * len(chunks),
                                                     16))
    assert chunks[0][1] == src - mis
    assert chunks[-1][1] + chunks[-1][2] == src + valid * itemsize
    assert all(r == 16 for _, _, r in chunks[:-1])
    assert 16 * len(chunks) <= tb + 16  # the row stride holds them


@pytest.mark.parametrize("n", range(1, 65))
@pytest.mark.parametrize("itemsize", [2, 1])
def test_narrow_shared_memory_stays_under_its_limit(n, itemsize):
    plan = pairdist_plan(1, n, 1 << 20, itemsize, H100_SMS)
    assert plan.smem == narrow_smem_bytes(n, plan.tile * itemsize, itemsize)
    assert plan.smem <= NARROW_SMEM_MAX < SMEM_LIMIT
    assert plan.threads == NARROW_THREADS and plan.phases == 1


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("shape", [(1, 13, 11958), (36, 13, 11958),
                                   (1, 13, 1048576), (8, 13, 1048576)])
def test_narrow_plans_cut_tiles_by_their_width(itemsize, shape):
    """A narrow tile holds 512 columns, so the same row needs half the
    float32 tiles, and the grid is one wave of the CTAs an SM holds, each
    with the narrow kernels' shared memory."""
    b, n, d = shape
    plan = pairdist_plan(b, n, d, itemsize, H100_SMS)
    assert plan.tile == 2 * TILE
    assert -(-d // plan.tile) == -(-(-(-d // TILE)) // 2)
    assert plan.smem == narrow_smem_bytes(n, plan.tile * itemsize, itemsize)
    assert plan.ctas * plan.tiles_per_cta * plan.tile >= d
    per_sm = SM_SMEM // (plan.smem + BLOCK_RESERVE)
    assert plan.ctas * b <= per_sm * H100_SMS  # one wave


@pytest.mark.parametrize("shape,want", [
    ((1, 13, 11958), (16, 1, 3)), ((36, 13, 11958), (16, 1, 3)),
    ((1, 13, 1048576), (8, 64, 8)), ((8, 13, 1048576), (8, 9, 57))])
def test_float32_plans_are_as_before(shape, want):
    """The float32 class keeps its tile, its cut and so its bits."""
    plan = pairdist_plan(*shape, 4, H100_SMS)
    assert (plan.cluster, plan.groups, plan.tiles_per_cta) == want
    assert plan.tile == TILE
    assert plan.smem == smem_bytes(shape[1], plan.phases, 4)
