"""The control (``xabench/control.py``) in the program's place comes out
not correct in every cell, at a small size on the CPU: the floor-dividing
decoder, and the search that sums its error in bfloat16."""

from __future__ import annotations

import time

import pytest

from xabench import control, run
from xabench._testing import CELLS, small_cell


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = small_cell(cell, blocks=200)
    with control.in_place():
        res = run.run_cell(c, 2**36 + 9, 0.3, False, "cpu",
                           time.perf_counter())
    assert not res["correct"], res["checks"]
    assert res["checks"]["outputs_wrong"]["value"] > 0
