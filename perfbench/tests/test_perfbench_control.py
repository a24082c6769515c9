"""Each cell's control at the cell's own size, on the card: the reference
computed in the next precision below the configuration's, put in the
port's place (bfloat16 for the splatting cells, whose float32 math has no
matrix products; TF32 for the stacked cells, which state float32 with TF32
off), must come out not correct on every seed. Runs only on the card:

    python3 -m pytest perfbench/tests -m gpu
"""

import pytest

from perfbench import core

SEEDS = (2_900_000_007, 2_900_500_011, 2_901_000_013)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["splat_serve", "stacked_train"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda, name, seed):
    cell = core.Cell(core.load_benchmark(), name)
    out = cell.driver().control(cell, seed, cuda)
    assert not all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]
