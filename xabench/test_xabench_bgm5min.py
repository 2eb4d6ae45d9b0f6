"""The song cell ``bgm5min.file_encode``: its configuration and traffic
mix load through :mod:`xabench.spec`, and the readers of the call's minor
faults (``bgm5min.minor_faults``, ``file_encode.minor_faults``) read the
root span's ``minflt`` on hand-made records, nothing where the program
counts none, and a small traced run of the cell on the CPU."""

from __future__ import annotations

import time
import types

import pytest

from xabench import gen, program_spans, run, spec
from xabench._testing import small_cell

CELL = "bgm5min.file_encode"
FAULTS = ("bgm5min.minor_faults", "file_encode.minor_faults")
MS = 1_000_000  # ns


def _call(first_id: int, t0: int, attrs: dict) -> list:
    """One wav_to_xa request: a root of 10 ms carrying ``attrs`` and one
    stage."""
    return [
        {"name": "bjxa.format.load_pcm", "id": first_id + 1,
         "parent": first_id, "request": first_id, "thread": 1,
         "start_ns": t0, "end_ns": t0 + MS, "attrs": {}},
        {"name": "bjxa.api.wav_to_xa", "id": first_id, "parent": None,
         "request": first_id, "thread": 1, "start_ns": t0,
         "end_ns": t0 + 10 * MS, "attrs": attrs},
    ]


def test_song_config_and_traffic_load_through_spec():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["frames"] == 13_230_000
    assert cell.config["channels"] == [2] and cell.config["bits"] == [6]
    assert cell.config["reduced"] == []
    assert cell.config["signal"] == spec.load_cell(
        "fixture15s.file_encode").config["signal"]
    assert cell.traffic == {**cell.traffic, "driver": "file",
                            "direction": "encode", "bits": 6,
                            "files_per_format": 8}
    specs = gen.file_specs(cell.config, cell.traffic, seed=2**33 + 5)
    assert len(specs) == 8 and len({s.index for s in specs}) == 8
    assert {(s.channels, s.bits, s.blocks) for s in specs} == {(2, 6,
                                                                413_438)}
    assert {m["name"] for m in cell.end_to_end} == {"file_encode_p95_ms",
                                                   "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert "bgm5min.minor_faults" in names
    assert "file_encode.minor_faults" not in names
    fixture = {m["name"] for m in spec.load_cell(
        "fixture15s.file_encode").per_layer}
    assert "file_encode.minor_faults" in fixture and not names & fixture


@pytest.mark.parametrize("metric", FAULTS)
def test_minor_faults_reads_the_median_of_the_roots_minflt(monkeypatch,
                                                           metric):
    records = (_call(1, 0, {"minflt": 12, "grown_bytes": 0})
               + _call(10, 100 * MS, {"minflt": 3, "grown_bytes": 0})
               + _call(20, 200 * MS, {"minflt": 5000, "grown_bytes": 64}))
    monkeypatch.setattr(program_spans, "records", lambda: records)
    monkeypatch.setattr(program_spans, "dropped", lambda: 0)
    got = spec.reader(metric)(types.SimpleNamespace(traced=None))
    assert got == {"value": 12, "calls": 3}
    # the traced window's last two calls only
    got = spec.reader(metric)(types.SimpleNamespace(
        traced=types.SimpleNamespace(attempted=2)))
    assert got["value"] == pytest.approx((3 + 5000) / 2)


@pytest.mark.parametrize("metric", FAULTS)
def test_minor_faults_reads_none_without_the_attribute(monkeypatch, metric):
    """A program older than the attribute (the parent of the change that
    adds it) reads nothing, and does not raise."""
    monkeypatch.setattr(program_spans, "records",
                        lambda: _call(1, 0, {}) + _call(10, 100 * MS, {}))
    assert spec.reader(metric)(types.SimpleNamespace(traced=None)) is None


def test_small_traced_run_of_the_song_cell():
    """The song cell cut to 80-block files (the fixed point's route),
    traced on the CPU: correct, and every per-layer metric the program's
    spans and the clock give, the minor faults and the fixed point's
    counters among them."""
    from bjxa_tpu_torch.utils import profiler

    profiler.clear()
    cell = small_cell(CELL, blocks=80)
    assert cell.config["frames"] == 80 * 32 - 3
    res = run.run_cell(cell, 2**40 + 20, 0.5, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    device_side = {"encode_roofline.bgm5min", "device.idle_share.bgm5min"}
    want = {m["name"] for m in spec.load_cell(CELL).per_layer} - device_side
    assert want <= set(res["metrics"])
    assert res["metrics"]["bgm5min.minor_faults"]["value"] >= 0
    assert res["metrics"]["encode_fixpoint.rounds.bgm5min"]["value"] >= 1
    profiler.clear()
