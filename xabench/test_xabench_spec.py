"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, its traffic mix and a reader for each of its metrics, and
a small run of it on the CPU reports every end-to-end metric."""

from __future__ import annotations

import pytest

from xabench import spec
from xabench._testing import run_small

WORKLOADS = [w["name"] for w in spec.bench()["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", WORKLOADS)
def test_small_run_reports_every_end_to_end_metric(name):
    cell = spec.load_cell(name)
    res = run_small(name, seconds=2.0)  # a percentile wants a few calls
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
