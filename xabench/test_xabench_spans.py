"""The readers of the program's spans (``xabench/program_spans.py`` and the
six metrics on it) on hand-made records, and on a small traced run of
the file encode on the CPU."""

from __future__ import annotations

import types

import pytest

from xabench import program_spans, spec
from xabench._testing import run_small

METRICS = ("file_encode.staging_ms", "file_encode.h2d_ms",
           "file_encode.readback_ms", "file_encode.assemble_ms",
           "file_encode.unspanned_ms", "encode_fixpoint.rounds.file")
MS = 1_000_000  # ns


def _call(first_id: int, t0: int, rounds: int, stages=None) -> list:
    """One wav_to_xa request: a root of 10 ms at ``t0`` and its stages
    (name, start, end in ms from ``t0``), children first."""
    stages = stages or [
        ("bjxa.format.parse_riff", 0.0, 0.5), ("bjxa.format.load_pcm", 0.5,
                                               1.5),
        ("bjxa.api.pad", 1.5, 2.0), ("bjxa.ops.h2d", 2.0, 2.25),
        ("bjxa.ops.search", 2.25, 3.0), ("bjxa.ops.deflate", 3.0, 3.5),
        ("bjxa.ops.readback", 3.5, 8.0), ("bjxa.api.assemble", 8.5, 9.5)]
    recs = []
    for i, (name, a, b) in enumerate(stages, 1):
        attrs = {"rounds": rounds} if name == "bjxa.ops.search" else {}
        recs.append({"name": name, "id": first_id + i, "parent": first_id,
                     "request": first_id, "thread": 1,
                     "start_ns": t0 + int(a * MS), "end_ns": t0 + int(b * MS),
                     "attrs": attrs})
    recs.append({"name": "bjxa.api.wav_to_xa", "id": first_id,
                 "parent": None, "request": first_id, "thread": 1,
                 "start_ns": t0, "end_ns": t0 + 10 * MS,
                 "attrs": {}})
    return recs


def _read(monkeypatch, records, attempted=None) -> dict:
    monkeypatch.setattr(program_spans, "records", lambda: records)
    traced = (None if attempted is None
              else types.SimpleNamespace(attempted=attempted))
    ctx = types.SimpleNamespace(traced=traced)
    out = {}
    for m in METRICS:
        got = spec.reader(m)(ctx)
        out[m] = got["value"] if isinstance(got, dict) else got
    return out


def test_readers_on_made_records(monkeypatch):
    records = (_call(1, 0, rounds=6) + _call(20, 100 * MS, rounds=8)
               + _call(40, 200 * MS, rounds=7))
    got = _read(monkeypatch, records)
    assert got == pytest.approx({
        "file_encode.staging_ms": 2.0, "file_encode.h2d_ms": 0.25,
        "file_encode.readback_ms": 4.5, "file_encode.assemble_ms": 1.0,
        # 8.0-8.5 and 9.5-10.0 lie under no stage
        "file_encode.unspanned_ms": 1.0, "encode_fixpoint.rounds.file": 7.0})


def test_readers_take_the_traced_windows_calls(monkeypatch):
    """Only the last ``attempted`` requests: a process may have traced
    before the window."""
    stages = [("bjxa.format.parse_riff", 0.0, 9.0)]
    records = (_call(1, 0, rounds=50, stages=stages)
               + _call(20, 100 * MS, rounds=8) + _call(40, 200 * MS, rounds=6))
    got = _read(monkeypatch, records, attempted=2)
    assert got["file_encode.staging_ms"] == pytest.approx(2.0)
    assert got["encode_fixpoint.rounds.file"] == 7.0


def test_readers_report_records_the_store_dropped(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: _call(1, 0, 3))
    ctx = types.SimpleNamespace(traced=None)
    monkeypatch.setattr(program_spans, "dropped", lambda: 0)
    assert "dropped" not in spec.reader("file_encode.h2d_ms")(ctx)
    monkeypatch.setattr(program_spans, "dropped", lambda: 9)
    for m in METRICS:
        assert spec.reader(m)(ctx)["dropped"] == 9, m


def test_unspanned_counts_overlap_once(monkeypatch):
    stages = [("bjxa.format.parse_riff", 1.0, 4.0),
              ("bjxa.format.load_pcm", 2.0, 3.0),
              ("bjxa.api.pad", 3.5, 6.0), ("bjxa.ops.search", 9.0, 12.0)]
    got = _read(monkeypatch, _call(1, 0, 1, stages))
    # covered 1.0-6.0 and 9.0-10.0 (the root ends at 10)
    assert got["file_encode.unspanned_ms"] == pytest.approx(4.0)
    assert got["file_encode.h2d_ms"] is None  # no such span: no value


@pytest.mark.parametrize("records", [
    [],
    # spans of other requests: a corpus stage, an orphan stage
    [{"name": "bjxa.corpus.stage", "id": 1, "parent": None, "request": 1,
      "thread": 1, "start_ns": 0, "end_ns": MS, "attrs": {}},
     {"name": "bjxa.ops.search", "id": 2, "parent": None, "request": 2,
      "thread": 1, "start_ns": 0, "end_ns": MS, "attrs": {"rounds": 3}}],
], ids=["empty", "no_wav_to_xa"])
def test_no_request_reads_none(monkeypatch, records):
    assert set(_read(monkeypatch, records).values()) == {None}


def test_no_program_store_reads_none(monkeypatch):
    """A program older than its spans has no ``records``: no records, and
    the readers read None without raising."""
    from bjxa_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "records")
    monkeypatch.delattr(profiler, "dropped")
    assert program_spans.records() == [] and program_spans.dropped() == 0
    ctx = types.SimpleNamespace(traced=types.SimpleNamespace(attempted=3))
    assert {spec.reader(m)(ctx) for m in METRICS} == {None}


def test_small_traced_run_reports_the_span_metrics():
    from bjxa_tpu_torch.utils import profiler

    profiler.clear()
    res = run_small("fixture15s.file_encode", trace=True, seconds=0.5)
    assert res["correct"], res["checks"]
    roots = [r for r in profiler.records()
             if r["name"] == "bjxa.api.wav_to_xa"]
    for m in METRICS:
        assert m in res["metrics"], m
        assert res["metrics"][m]["calls"] == len(roots)
    # the untraced window's calls are no records: spans were off then
    assert 0 < len(roots) < res["attempted"]
    assert res["metrics"]["encode_fixpoint.rounds.file"]["value"] >= 1
    assert res["breakdown"]["device_ops"] == []  # the CPU runs no device op
    profiler.clear()
