"""The fp32 L1 backward kernel's launch plan (``l1_frontend.bwd_f32_plan``).

The kernel (``csrc/l1_frontend_f32.cu``) runs only on the card; its tiles,
ring and grid come from this host-side plan, so these tests hold the plan
at the WavLM-Base and WavLM-Large pretraining shapes and at short, ragged
and wide ones: every (utterance, row) is in exactly one tile and no tile
crosses an utterance; each consumer thread's rows and samples lie inside
its stage; the ring fits a block's shared memory with its barriers and
holds the final reduction; every copy starts on a 16-byte boundary; and
the grid never asks for more blocks than the card holds at once. The walk
below mirrors the kernel's indexing (tile = block + i * grid).
"""

import pathlib
import re

import numpy as np
import pytest

from unispeech_tpu_torch.ops.kernels import l1_frontend as lf
from unispeech_tpu_torch.scripts import bench_l1_backward

SOURCE = (pathlib.Path(lf.__file__).resolve().parents[2] / "csrc" / "l1_frontend_f32.cu")

# (B, t1): WavLM-Base / WavLM-Large pretraining (6 / 3 crops of 245,840
# samples), one short utterance (fewer tiles than blocks), short, ragged
# and long ones with several utterances
SHAPES = [(6, 49_167), (3, 49_167), (1, 79), (2, 79), (2, 97), (3, 333), (2, 999), (2, 9_600)]
CHANNELS = [64, 192, 512, 1024]
GEOMETRIES = [(10, 5), (8, 4)]
H100_SMS = 132


def _ns(t1, k, s, extra):
    """Samples of an utterance with t1 windows and ``extra`` ragged ones."""
    return (t1 - 1) * s + k + extra


def _walk(plan, B, t1):
    """(block, b, t0, rows < t1) of every tile, in the kernel's order."""
    n_tiles = B * plan.tiles_per_b
    for block in range(plan.grid):
        for tile in range(block, n_tiles, plan.grid):
            b, t0 = divmod(tile, plan.tiles_per_b)
            t0 *= plan.rows
            yield block, b, t0, min(plan.rows, t1 - t0)


@pytest.mark.parametrize("k,s", GEOMETRIES)
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("B,t1", SHAPES)
def test_tiles_cover_each_row_once(B, t1, C, k, s):
    plan = lf.bwd_f32_plan(B, t1, C, k, s, H100_SMS)
    seen = np.zeros((B, t1), np.int32)
    blocks = set()
    for block, b, t0, nr in _walk(plan, B, t1):
        assert 0 < nr <= plan.rows and t0 + nr <= t1  # inside one utterance
        seen[b, t0:t0 + nr] += 1
        blocks.add(block)
    assert (seen == 1).all()
    assert blocks == set(range(plan.grid))  # no block without a tile
    # the consumer threads' row chunks (BWD_F32_ROWS each) tile R exactly
    lanes = plan.rows // lf.BWD_F32_ROWS
    assert lanes * lf.BWD_F32_ROWS == plan.rows
    assert lanes >= 1 and lanes * (C // 4) <= 32 * lf.BWD_F32_WARPS


@pytest.mark.parametrize("k,s", GEOMETRIES)
@pytest.mark.parametrize("C", CHANNELS)
def test_ring_fits_and_keeps_bytes_in_flight(C, k, s):
    """The ring depends on C and (k, s) alone."""
    plan = lf.bwd_f32_plan(6, 49_167, C, k, s, H100_SMS)
    dy_bytes = plan.rows * C * 4
    x_bytes = plan.x_boxes * lf.BWD_F32_X_BOX * 4
    assert plan.stage_bytes % 1024 == 0 and plan.stage_bytes >= dy_bytes + x_bytes
    # the ring, a full and an empty barrier per stage, 1024-byte alignment
    assert plan.smem == plan.stages * (plan.stage_bytes + 16) + 1024
    assert plan.smem <= lf.SMEM_BLOCK_MAX
    # at least four stages and 64 KB of dy in the ring besides the stage
    # being read; the block's final (k, C) reduction fits in the ring
    assert plan.stages >= 4 and (plan.stages - 1) * dy_bytes >= 64 * 1024
    assert k * C * 4 <= plan.stages * plan.stage_bytes


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("k,s", GEOMETRIES)
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("B,t1", [(3, 79), (2, 97), (3, 333), (2, 999)])
def test_copies_start_aligned_and_hold_the_rows(B, t1, C, k, s, extra):
    """dy: one bulk copy of the tile's rows < t1 into the stage; samples:
    x_boxes TMA boxes from the 16-byte boundary at or before b ns + t0 s,
    which hold every sample a thread reads (its BWD_F32_ROWS rows' taps,
    from up to 3 samples past the boundary). ``extra`` samples past the
    last window put the utterances' starts off 16-byte boundaries."""
    plan = lf.bwd_f32_plan(B, t1, C, k, s, H100_SMS)
    ns = _ns(t1, k, s, extra)
    assert (ns - k) // s + 1 == t1
    dy_bytes = plan.rows * C * 4
    x_floats = plan.x_boxes * lf.BWD_F32_X_BOX
    offsets = set()
    for _, b, t0, nr in _walk(plan, B, t1):
        src = (b * t1 + t0) * C * 4
        assert src % 16 == 0 and (nr * C * 4) % 16 == 0 and nr * C * 4 <= dy_bytes
        assert dy_bytes % 128 == 0  # the boxes' destination after dy
        first = b * ns + t0 * s
        x0 = first & ~3
        assert (x0 * 4) % 16 == 0 and 0 <= first - x0 <= 3
        offsets.add(first - x0)
        # every row < t1 of the tile: its last tap inside the boxes
        assert first + (nr - 1) * s + k <= x0 + x_floats
        # the known-geometry path reads (ROWS - 1) s + k samples per thread
        # from its chunk's first row, whatever rows are < t1
        last_chunk = plan.rows - lf.BWD_F32_ROWS
        assert (first - x0) + last_chunk * s + (lf.BWD_F32_ROWS - 1) * s + k <= x_floats
    if B > 1 and ns % 4:
        assert offsets != {0}  # the case this test is for: windows off a boundary


@pytest.mark.parametrize("sms", [H100_SMS, 114, 8])
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("B,t1", SHAPES)
def test_grid_within_resident_blocks(B, t1, C, sms):
    plan = lf.bwd_f32_plan(B, t1, C, 10, 5, sms)
    resident = lf.SMEM_SM // (plan.smem + 1024)
    assert resident == 1  # the ring takes over half of an SM's shared memory
    assert 1 <= plan.grid <= sms * resident
    assert plan.grid == min(B * plan.tiles_per_b, sms)  # persistent: no tail wave


def test_plan_at_the_pretraining_shape():
    """WavLM-Base pretraining on an H100: 16-row tiles (2 row lanes of 128
    threads), 33,792-byte stages (32 KB of dy, one box of samples), four
    of them, 132 blocks over 18,438 tiles."""
    plan = lf.bwd_f32_plan(6, 49_167, 512, 10, 5, H100_SMS)
    assert plan == lf.BwdF32Plan(rows=16, x_boxes=1, stage_bytes=33_792, stages=4,
                                 smem=136_256, tiles_per_b=3_073, grid=132)


def test_plan_constants_match_the_kernel():
    """The plan's constants are the kernel source's."""
    text = SOURCE.read_text()
    want = {"kBwdWarps": lf.BWD_F32_WARPS, "kBwdRows": lf.BWD_F32_ROWS,
            "kXBox": lf.BWD_F32_X_BOX, "kSmemMax": lf.SMEM_BLOCK_MAX}
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m is not None and int(m.group(1)) == value, name
    # the kernel checks the same stage size and shared memory as the plan
    assert "(rows * C * 4 + x_boxes * kXBox * 4 + 1023) / 1024 * 1024" in text
    assert "n_stages * stage_bytes + 16 * n_stages + 1024" in text
    assert "(stride * rows + k - stride + 3 + kXBox - 1) / kXBox" in text


@pytest.mark.parametrize("name", sorted(bench_l1_backward.VARIANTS))
def test_bench_variants_match_the_source(name):
    """Each variant of ``scripts/bench_l1_backward.py --variants`` finds the
    text it replaces in the kernel source, once."""
    text = SOURCE.read_text()
    for old, _ in bench_l1_backward.VARIANTS[name]:
        assert text.count(old) == 1, old
