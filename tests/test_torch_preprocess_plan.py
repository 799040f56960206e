"""The fused preprocess kernel's host-side plan, on the CPU.

The CUDA kernel reads its resize windows from ``window_table`` and the rows
each block owns from ``tile_plan``. The window tables must rebuild the JAX
package's area-weight matrices bit for bit, and the tiles must cover every
output row once with its whole window inside the rows the tile loads.
"""

import numpy as np
import pytest

from gelslim_depth_tpu.ops.resize import _area_weight_matrix as jax_area_weight_matrix
from gelslim_depth_tpu_torch.ops.kernels import preprocess_kernel as pk

AXIS_PAIRS = [(320, 160), (427, 213), (64, 32), (86, 43), (160, 320), (213, 427), (33, 16), (47, 23)]

# (h_in, w_in, h_out, w_out): the flagship, overlapping row windows,
# upsampling, and planes whose bytes are not a multiple of 16
SHAPES = [
    (320, 427, 160, 213),
    (321, 427, 160, 213),
    (64, 86, 32, 43),
    (160, 213, 320, 427),
    (33, 47, 16, 23),
    (16, 21, 32, 43),
]


@pytest.mark.parametrize("n_in,n_out", AXIS_PAIRS)
def test_window_table_rebuilds_the_jax_weight_matrix_bit_for_bit(n_in, n_out):
    t = pk.window_table(n_in, n_out)
    assert t.start.dtype == np.int32 and t.end.dtype == np.int32 and t.weight.dtype == np.float32
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        w[i, t.start[i]:t.end[i]] = t.weight[i]
    want = jax_area_weight_matrix(n_in, n_out)
    assert w.dtype == want.dtype and w.shape == want.shape
    np.testing.assert_array_equal(w.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("h_in,w_in,h_out,w_out", SHAPES)
def test_tiles_cover_each_output_row_once_inside_the_rows_they_load(h_in, w_in, h_out, w_out):
    plan = pk.tile_plan(h_in, w_in, h_out, w_out)
    rows = pk.window_table(h_in, h_out)
    assert plan.tiles.dtype == np.int32 and plan.tiles.shape[1] == 4
    covered = np.zeros(h_out, np.int64)
    for o0, o1, r0, r1 in plan.tiles:
        assert 0 < o1 - o0 <= plan.tile_rows <= pk.ROWS_PER_TILE
        assert 0 <= r0 < r1 <= h_in and r1 - r0 <= plan.max_tile_rows
        covered[o0:o1] += 1
        for o in range(o0, o1):
            assert r0 <= rows.start[o] and rows.end[o] <= r1
    np.testing.assert_array_equal(covered, 1)
    assert plan.max_tile_rows == max(r1 - r0 for _, _, r0, r1 in plan.tiles)
    assert pk.smem_bytes(plan.tile_rows, plan.max_tile_rows, w_in, w_out) <= pk.SMEM_LIMIT


def test_flagship_tiles_are_whole_16_byte_spans():
    """At 320x427 -> 160x213 every tile's span of rows starts and ends on
    16 B within its plane, so only the 16-B copies run there."""
    plan = pk.tile_plan(320, 427, 160, 213)
    assert plan.tile_rows == pk.ROWS_PER_TILE and (320 * 427 * 4) % 16 == 0
    for _, _, r0, r1 in plan.tiles:
        assert (r0 * 427 * 4) % 16 == 0 and ((r1 - r0) * 427 * 4) % 16 == 0


def test_tall_windows_shrink_the_tile_or_raise():
    # 320 -> 40 rows: an 8-row window of 1,000 columns fits one output row a tile
    plan = pk.tile_plan(320, 1000, 40, 500)
    assert plan.tile_rows == 1 and plan.max_tile_rows == 8
    assert pk.smem_bytes(1, 8, 1000, 500) <= pk.SMEM_LIMIT < pk.smem_bytes(2, 16, 1000, 500)
    with pytest.raises(ValueError):
        pk.tile_plan(320, 427, 1, 1)  # the whole plane is one window
