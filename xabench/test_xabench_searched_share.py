"""The reader of ``encode_fixpoint.searched_share.file`` on hand-made span
records, and on a small traced run of the file encode on the CPU."""

from __future__ import annotations

import time
import types

import pytest

from xabench import program_spans, run, spec
from xabench._testing import small_cell

METRIC = "encode_fixpoint.searched_share.file"
MS = 1_000_000  # ns


def _call(first_id: int, t0: int, attrs: dict) -> list:
    """One wav_to_xa request: its search span with ``attrs``, then its
    root."""
    return [{"name": "bjxa.ops.search", "id": first_id + 1,
             "parent": first_id, "request": first_id, "thread": 1,
             "start_ns": t0 + 2 * MS, "end_ns": t0 + 3 * MS, "attrs": attrs},
            {"name": "bjxa.api.wav_to_xa", "id": first_id, "parent": None,
             "request": first_id, "thread": 1, "start_ns": t0,
             "end_ns": t0 + 10 * MS, "attrs": {}}]


def _read(monkeypatch, records, attempted=None):
    monkeypatch.setattr(program_spans, "records", lambda: records)
    monkeypatch.setattr(program_spans, "dropped", lambda: 0)
    traced = (None if attempted is None
              else types.SimpleNamespace(attempted=attempted))
    return spec.reader(METRIC)(types.SimpleNamespace(traced=traced))


def test_mean_over_calls_of_searched_over_item_rounds(monkeypatch):
    records = (
        _call(1, 0, {"rounds": 10, "searched": 5168, "items": 2584})
        + _call(20, 100 * MS, {"rounds": 4, "searched": 1292, "items": 1292})
        + _call(40, 200 * MS, {"rounds": 1, "searched": 2584,
                               "items": 2584}))
    got = _read(monkeypatch, records)
    assert got["calls"] == 3
    assert got["value"] == pytest.approx((0.2 + 0.25 + 1.0) / 3)


def test_only_the_traced_windows_calls(monkeypatch):
    records = (_call(1, 0, {"rounds": 2, "searched": 2, "items": 1})
               + _call(20, 100 * MS, {"rounds": 5, "searched": 10,
                                      "items": 4}))
    assert _read(monkeypatch, records, attempted=1)["value"] == 0.5


@pytest.mark.parametrize("attrs", [
    {"rounds": 7},  # a program that counts no searched items: the parent's
    {"rounds": 1, "searched": None, "items": 4},  # a failed call
    {"rounds": 0, "searched": 0, "items": 2},  # no blocks: no round
    {},
], ids=["rounds_only", "failed", "no_round", "no_attributes"])
def test_calls_without_a_count_read_none(monkeypatch, attrs):
    assert _read(monkeypatch, _call(1, 0, attrs)) is None


def test_small_traced_run_reports_the_share():
    """Files of 96 blocks, so each call takes the fixed point (K = 6)."""
    from bjxa_tpu_torch.utils import profiler

    profiler.clear()
    res = run.run_cell(small_cell("fixture15s.file_encode", blocks=96),
                       2**40 + 11, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    got = res["metrics"][METRIC]
    roots = [r for r in profiler.records()
             if r["name"] == "bjxa.api.wav_to_xa"]
    assert got["calls"] == len(roots) > 0
    assert 0 < got["value"] <= 1
    profiler.clear()
