"""Kernel G's table sectors per launch, counted on the CPU
(``tools/kernel_ablation.py``: ``table_sectors``, ``sector_counts``, the
``--sectors`` mode), on hand-made levels whose answer is known.

A count is the number of 32-byte sectors one warp-wide load touches (32
consecutive samples), summed over the loads: one load per corner before
the pair loads; with them, per dim-0 pair one 16-byte load of the unit
holding the first row, and a load of the second row only where it lies in
another unit.  The rows come from ``grid_ops.build_indices_weights``, the
plain grid arithmetic that kernel G equals on the card.
"""

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.common import GridType, HashType
from tcnn_tpu_torch.ops import grid_ops
from tcnn_tpu_torch.tools.kernel_ablation import sector_counts, table_sectors


def level_rows(spec, x):
    """(2^D, B) rows of level 0 for the samples x."""
    idx, _ = grid_ops.build_indices_weights(spec, torch.as_tensor(x, dtype=torch.float32), [0])
    return idx.reshape(1 << spec.n_dims, -1)


# A dense 1-D level of 256 rows: cell c's corners on rows c and c + 1,
# and the last cell's second corner wrapped to row 0.
DENSE_1D = grid_ops.make_grid_spec(1, 1, 2, 12, 256, 1.5, grid_type=GridType.DENSE)


def cell_x(cells):
    """x whose sample falls in each cell of DENSE_1D, mid-cell."""
    scale = DENSE_1D.levels[0].scale
    return (np.asarray(cells, np.float32)[:, None] + 0.0) / np.float32(scale)


def test_dense_level_is_what_the_counts_assume():
    lv = DENSE_1D.levels[0]
    assert (lv.size, lv.use_hash, lv.offset) == (256, False, 0)
    rows = level_rows(DENSE_1D, cell_x([5, 255]))
    assert rows.tolist() == [[5, 255], [6, 0]]


@pytest.mark.parametrize("cell,row_bytes,before,after", [
    (5, 4, 2, 1),     # rows 5, 6: one 4-row unit (bf16, F = 2)
    (7, 4, 2, 2),     # rows 7, 8 straddle the unit's end
    (6, 8, 2, 1),     # rows 6, 7: one 2-row unit (fp32, F = 2)
    (5, 8, 2, 2),     # rows 5, 6 straddle it
    (9, 2, 2, 1),     # rows 9, 10: one 8-row unit (bf16, F = 1)
    (15, 2, 2, 2),    # rows 15, 16 straddle it
    (254, 4, 2, 1),   # rows 254, 255: the level's last unit
    (255, 4, 2, 2),   # rows 255, 0: the wrap
    (255, 8, 2, 2),
    (5, 16, 2, 2),    # 16-byte rows (fp32, F = 4): no pair loads
    (5, 12, 3, 3),    # 12-byte rows (fp32, F = 3): none either; row 5 straddles a sector
])
def test_one_sample_of_a_dense_level(cell, row_bytes, before, after):
    rows = level_rows(DENSE_1D, cell_x([cell]))
    assert table_sectors(rows, row_bytes, paired=False) == before
    assert table_sectors(rows, row_bytes, paired=True) == after


def test_a_warp_of_a_dense_level():
    """32 samples, one warp: sample i in cell 4i + 1 (rows 4i + 1, 4i + 2,
    unit i of bf16 F = 2 rows, sector i // 2) or in cell 4i + 3 (rows
    4i + 3 in unit i, 4i + 4 in unit i + 1, sector (i + 1) // 2)."""
    inside = level_rows(DENSE_1D, cell_x([4 * i + 1 for i in range(32)]))
    assert table_sectors(inside, 4, paired=False) == 16 + 16
    assert table_sectors(inside, 4, paired=True) == 16
    straddling = level_rows(DENSE_1D, cell_x([4 * i + 3 for i in range(32)]))
    assert table_sectors(straddling, 4, paired=False) == 16 + 17
    assert table_sectors(straddling, 4, paired=True) == 16 + 17
    # a second warp counts apart: the same 32 samples twice, twice the sectors
    twice = torch.cat([inside, inside], dim=1)
    assert table_sectors(twice, 4, paired=True) == 2 * 16


def test_a_row_straddling_two_sectors_counts_both():
    """A 12-byte row at byte 24 covers sectors 0 and 1, the next (byte 36)
    sector 1 alone."""
    rows = torch.tensor([[2], [3]])
    assert table_sectors(rows, 12, paired=False) == 2 + 1


# A hashed 2-D CoherentPrime level of 2^14 rows: corners c, c|1 on rows
# r, r ^ 1 from an even cell[0] (one 2-row unit of fp32 F = 2 rows), and
# from an odd one on rows that differ in bit 1 too (another unit).
XOR_2D = grid_ops.make_grid_spec(2, 1, 2, 14, 1024, 1.5, hash_type=HashType.COHERENT_PRIME)


@pytest.mark.parametrize("cell0,after", [(100, 2), (101, 4), (102, 2), (103, 4)])
def test_one_sample_of_an_xor_level(cell0, after):
    lv = XOR_2D.levels[0]
    assert lv.use_hash and lv.size == 1 << 14
    x = np.array([[cell0, 333]], np.float32) / np.float32(lv.scale)
    rows = level_rows(XOR_2D, x)
    assert int(torch.floor(torch.tensor(x[0, 0]) * lv.scale + 0.5)) == cell0
    r0, r1 = rows[0::2], rows[1::2]
    assert bool(((r0 ^ r1) == 1).all()) == (cell0 % 2 == 0)
    assert table_sectors(rows, 8, paired=False) == 4
    assert table_sectors(rows, 8, paired=True) == after


def test_sector_counts_at_the_repos_shapes():
    """Pair loads cut G's sectors at config_hash, config_btf and the SDF
    step: config_btf's CoherentAdd pairs share a 4-row unit unless the
    first row ends it, so its fine levels need 10 loads for 16 corners."""
    counts = sector_counts(batch=4096)
    assert set(counts) == {"G config_hash", "G config_btf", "G sdf"}
    for before, after in counts.values():
        assert 0 < after < before
    before, after = counts["G config_btf"]
    assert abs(after / before - 10 / 16) < 0.02
