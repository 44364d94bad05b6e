"""The RVQ kernel's launch plan (``nat_tpu_torch.ops.rvq_kernel.launch_plan``),
chosen on the host from (M, K, SM count, blocks an SM holds): its items must cover every
(row, code) pair exactly once, and one block must fit the card's shared
memory (232,448 bytes a block on sm_90).  Runs on the CPU: the plan is
plain Python, and the kernel checks the same limits when it is launched.
"""

import math

import numpy as np
import pytest
import torch

from nat_tpu_torch.ops import rvq_kernel
from nat_tpu_torch.ops.rvq_kernel import launch_plan

# (m, k) around the row tiles and the 32-code chunk.
RAGGED = [(1, 1), (1, 33), (17, 4097), (31, 32), (32, 31), (33, 65),
          (81, 1000), (81, 4096), (88, 4096), (127, 129), (129, 4096),
          (200, 4096), (257, 97), (648, 4096), (1000, 3)]
# Blocks an SM holds at once for row tiles 32, 64 and 96: one of each, and
# more of the smaller tiles.
OCCUPANCY = [(1, 1, 1), (3, 1, 1)]


@pytest.mark.parametrize("m,k", RAGGED)
@pytest.mark.parametrize("sm_count", [1, 132])
def test_items_cover_every_row_and_code_once(m, k, sm_count):
    plan = launch_plan(m, k, sm_count, (1, 1, 1))
    hits = np.zeros((m, k), dtype=np.int32)
    for rows, codes in plan.items():
        assert len(rows) <= plan.row_tile and len(codes) <= rvq_kernel.CODE_CHUNK
        hits[rows.start:rows.stop, codes.start:codes.stop] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("m,k", RAGGED)
def test_plan_fits_one_block(m, k):
    plan = launch_plan(m, k, 132, (3, 1, 1))
    assert (plan.m, plan.k) == (m, k)
    assert plan.row_tile in rvq_kernel.ROW_TILES == (32, 64, 96)
    assert plan.row_tiles * plan.row_tile >= m
    assert plan.row_tiles == math.ceil(m / plan.row_tile)
    assert plan.code_chunks == math.ceil(k / rvq_kernel.CODE_CHUNK)
    assert rvq_kernel.THREADS_PER_ROW * plan.row_tile <= 384
    assert plan.smem_bytes == rvq_kernel.smem_bytes(plan.row_tile)
    assert plan.smem_bytes <= rvq_kernel.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("m,k", RAGGED)
@pytest.mark.parametrize("per_sm", OCCUPANCY)
def test_grid_stays_within_the_resident_blocks(m, k, per_sm):
    """A cooperative launch takes at most what the SMs hold at once; below
    that, a block for each item and a warp for each row."""
    plan = launch_plan(m, k, 132, per_sm)
    resident = 132 * per_sm[rvq_kernel.ROW_TILES.index(plan.row_tile)]
    wanted = max(plan.row_tiles * plan.code_chunks,
                 math.ceil(m / (rvq_kernel.THREADS_PER_ROW * plan.row_tile
                                // 32)))
    assert plan.grid_blocks == min(wanted, resident) >= 1


def test_largest_plan_fits_shared_memory():
    assert rvq_kernel.smem_bytes(rvq_kernel.ROW_TILE_MAX) <= 232_448


@pytest.mark.parametrize("m", [81, 88])
def test_main_path_rows_pad_to_96(m):
    plan = launch_plan(m, 4096, 132, (3, 1, 1))
    assert plan.row_tile * plan.row_tiles == 96
    assert plan.grid_blocks == 128


def test_k1000_splits_rows_to_fill_the_card():
    plan = launch_plan(81, 1000, 132, (3, 1, 1))
    assert (plan.row_tile, plan.row_tiles) == (32, 3)


@pytest.mark.parametrize("k", [1000, 4096])
@pytest.mark.parametrize("sm_count", [1, 78, 132])
def test_plan_takes_the_fewest_rounds_over_the_sms(k, sm_count):
    for m in range(1, 700, 7):
        plan = launch_plan(m, k, sm_count, (1, 1, 1))
        rounds = math.ceil(plan.row_tiles * plan.code_chunks / sm_count)
        for tiles in range(math.ceil(m / rvq_kernel.ROW_TILE_MAX),
                           math.ceil(m / 32) + 1):
            other = tiles * plan.code_chunks
            assert rounds <= math.ceil(other / sm_count)


@pytest.mark.parametrize("args", [(0, 1, 1, (1, 1, 1)), (1, 0, 1, (1, 1, 1)),
                                  (1, 1, 0, (1, 1, 1)), (1, 1, 1, (1, 1)),
                                  (81, 4096, 132, (1, 1, 0))])
def test_plan_refuses_empty_shapes_and_cards(args):
    """Empty shapes, an occupancy without a count for each row tile, and a
    card that holds no block of the tile the plan needs."""
    with pytest.raises(ValueError):
        launch_plan(*args)


@pytest.mark.parametrize("tile,resident", [(48, 10), (128, 10), (96, 0)])
def test_plan_with_tile_refuses_other_tiles(tile, resident):
    with pytest.raises(ValueError):
        rvq_kernel.plan_with_tile(81, 4096, tile, resident)


def test_cpu_tensor_never_reaches_the_kernel():
    """The CUDA wrapper refuses a CPU tensor; the encode entry takes the
    plain chain for it without building anything."""
    cb = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_cuda(cb, torch.zeros(3, 4))
    state = rvq_kernel.RVQState.from_codebook(torch.randn(
        2, 8, 4, generator=torch.Generator().manual_seed(0)))
    before = rvq_kernel.launches
    codes, _, _ = rvq_kernel.rvq_encode(state, torch.zeros(1, 3, 4))
    assert rvq_kernel.launches == before and codes.shape == (2, 1, 3)
