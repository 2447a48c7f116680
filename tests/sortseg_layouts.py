"""Key layouts of the sortseg route's segment sums at the edges of kernel
SS's tiles (``ops/cuda/sort_scatter.py::SS_TILE`` sorted positions a CTA):
a run ending exactly at a tile boundary, a run over many tiles, fewer
positions than one tile, k tiles ± 1, only keys past the table, keys
below 0.  numpy only: the CPU tests against JAX and the card tests
(which import no JAX) both draw them.  The keys are not sorted."""

import numpy as np

N_ROWS = 512
FEATURES = [1, 2, 3, 4, 8, 12, 16]
NAMES = ["run-ends-at-tile-boundary", "run-over-many-tiles", "below-one-tile",
         "k-tiles-plus-1", "k-tiles-minus-1", "all-sentinels", "keys-below-0"]


def layout(name: str, tile: int) -> np.ndarray:
    """The (M,) int32 keys of layout ``name`` for a tile of ``tile``
    positions, rows [0, N_ROWS)."""
    rng = np.random.default_rng(NAMES.index(name))
    keys = {
        # run 3 ends at position tile, runs 4 and 5 at 2·tile
        "run-ends-at-tile-boundary": lambda: np.repeat([3, 4, 5, 6],
                                                       [tile, tile - 100, 100, 37]),
        "run-over-many-tiles": lambda: np.concatenate(
            [rng.integers(0, 10, 300), np.full(6 * tile + 5, 10), rng.integers(11, 40, 500)]),
        "below-one-tile": lambda: rng.integers(0, 64, tile // 2 - 24),
        "k-tiles-plus-1": lambda: rng.integers(0, N_ROWS, 3 * tile + 1),
        "k-tiles-minus-1": lambda: rng.integers(0, N_ROWS, 3 * tile - 1),
        "all-sentinels": lambda: np.full(2 * tile + 3, N_ROWS),
        "keys-below-0": lambda: rng.integers(-40, N_ROWS + 40, 2 * tile + 999),
    }[name]()
    return keys.astype(np.int32)
