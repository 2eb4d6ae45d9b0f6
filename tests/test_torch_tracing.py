"""The port's program spans (``bjxa_tpu_torch/utils/profiler.span``) on the
whole-file encode, on the CPU.

Off (no ``torch.profiler`` session) a span is one shared null object and
keeps nothing; on, each ``wav_to_xa`` call is one request of exactly nine
spans on the profiler's own clock, the search's span carries the fixed
point's rounds, and the bytes are the same either way.  Inputs are made
from a numpy seed; the stream is long enough (96 blocks) for K > 1.
"""

import json
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bjxa_tpu_torch import RIFF_HEADER_SIZE, api, dump_riff_header
from bjxa_tpu_torch.ops import cuda_encode, encode
from bjxa_tpu_torch.utils import profiler as prof

BLOCKS, CHANNELS, BITS = 96, 2, 6
SAMPLES = BLOCKS * 32 - 5
ROOT = "bjxa.api.wav_to_xa"
STAGES = ("bjxa.format.parse_riff", "bjxa.format.load_pcm", "bjxa.api.pad",
          "bjxa.ops.h2d", "bjxa.ops.search", "bjxa.ops.deflate",
          "bjxa.ops.readback", "bjxa.api.assemble")
CALLS = 2


def _wav() -> bytes:
    rng = np.random.default_rng(16)
    t = np.arange(SAMPLES)[:, None]
    sig = 14000 * np.sin(t / (4.0 + 0.7 * np.arange(CHANNELS)))
    sig += rng.normal(0, 2500, size=(SAMPLES, CHANNELS))
    pcm = np.clip(sig, -32768, 32767).astype("<i2")
    return dump_riff_header(pcm.size * 2, 44100, CHANNELS) + pcm.tobytes()


@pytest.fixture(scope="module")
def run():
    """One untraced call, then CALLS calls under a CPU profiler: their
    outputs, the store after each part, and the trace's events."""
    wav = _wav()
    prof.clear()
    off = api.wav_to_xa(wav, BITS, device="cpu")
    off_records = prof.records()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function("warm"):  # the profiler's first range pays
            pass                        # its set-up
        on = [api.wav_to_xa(wav, BITS, device="cpu") for _ in range(CALLS)]
    events = [e for e in p.profiler.kineto_results.events()
              if e.name().startswith("bjxa.")]
    records = prof.records()
    prof.clear()
    return {"wav": wav, "off": off, "off_records": off_records, "on": on,
            "records": records, "events": events}


def _requests(records) -> dict:
    by = defaultdict(list)
    for r in records:
        by[r["request"]].append(r)
    return by


def test_span_off_is_the_shared_null_object(run):
    assert not prof.recording()
    sp = prof.span("bjxa.test", bytes=1)
    assert sp is prof.NULL_SPAN and not sp
    with sp as inside:
        inside.set(n=2)
    assert run["off_records"] == []
    assert prof.records() == []


def test_bytes_equal_with_tracing_on_and_off(run):
    assert all(out == run["off"] for out in run["on"])


def test_each_call_is_one_request_of_nine_spans(run):
    requests = _requests(run["records"])
    assert len(requests) == CALLS
    for rid, recs in requests.items():
        assert Counter(r["name"] for r in recs) == Counter((ROOT, *STAGES))
        (root,) = [r for r in recs if r["parent"] is None]
        assert root["name"] == ROOT and root["id"] == rid
        for r in recs:
            assert r["thread"] == root["thread"]
            if r is not root:
                assert r["parent"] == root["id"]
                assert root["start_ns"] <= r["start_ns"] <= r["end_ns"]
                assert r["end_ns"] <= root["end_ns"]
        # the stages in the call's order, one after another
        kids = sorted((r for r in recs if r is not root),
                      key=lambda r: r["start_ns"])
        assert tuple(r["name"] for r in kids) == STAGES
        assert all(a["end_ns"] <= b["start_ns"]
                   for a, b in zip(kids, kids[1:]))


def test_records_share_the_profilers_clock(run):
    """Each record starts within 100 us of its own range in the trace."""
    by_name = defaultdict(list)
    for e in run["events"]:
        by_name[e.name()].append(e.start_ns())
    recs = defaultdict(list)
    for r in run["records"]:
        recs[r["name"]].append(r["start_ns"])
    assert set(by_name) == set(recs) == {ROOT, *STAGES}
    for name, starts in recs.items():
        assert len(starts) == len(by_name[name]) == CALLS
        for mine, theirs in zip(sorted(starts), sorted(by_name[name])):
            assert abs(mine - theirs) < 100_000, name


def test_span_attributes(run):
    """The search's span carries the fixed point's rounds, searched items
    and items, and the root the call's minor faults and buffer growth,
    which metrics read; no other span carries an attribute."""
    for recs in _requests(run["records"]).values():
        attrs = {r["name"]: r["attrs"] for r in recs}
        assert set(attrs["bjxa.ops.search"]) == {"rounds", "searched",
                                                 "items"}
        assert set(attrs[ROOT]) == {"minflt", "grown_bytes"}
        assert type(attrs[ROOT]["minflt"]) is int
        assert attrs[ROOT]["minflt"] >= 0
        # the untraced call before grew this thread's buffers to the shape
        assert attrs[ROOT]["grown_bytes"] == 0
        for name in STAGES:
            if name != "bjxa.ops.search":
                assert attrs[name] == {}, name


def _traced_calls(wavs) -> list:
    """The root records of ``wav_to_xa`` on each of ``wavs`` in turn, on a
    thread of its own (its buffers start empty), under a CPU profiler."""
    roots = []

    def work():
        with profile(activities=[ProfilerActivity.CPU]):
            for wav in wavs:
                prof.clear()
                api.wav_to_xa(wav, BITS, device="cpu")
                roots.extend(r for r in prof.records() if r["name"] == ROOT)
        prof.clear()

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return roots


def test_grown_bytes_counts_the_staging_buffers_growth():
    """A fresh thread's first call grows its staging buffer to the padded
    PCM (no readback buffer off the card); the same shape again, and a
    shorter one, grow nothing; a longer one grows it by the difference."""
    wav = _wav()
    body = wav[RIFF_HEADER_SIZE:]
    short = dump_riff_header(64 * 32 * 4, 44100, CHANNELS) + body[:64 * 128]
    longer = (dump_riff_header(len(body) * 2, 44100, CHANNELS)
              + body + body)
    got = [r["attrs"]["grown_bytes"]
           for r in _traced_calls([wav, wav, short, longer, wav])]
    padded = BLOCKS * 32 * CHANNELS * 2
    grown_to = -(-(2 * SAMPLES) // 32) * 32 * CHANNELS * 2
    assert got == [padded, 0, 0, grown_to - padded, 0]


def test_minflt_is_the_calls_difference_of_the_thread_count(monkeypatch):
    """The root's ``minflt`` is :func:`minor_faults` at its end less at its
    start; untraced, the count is never read."""
    reads = iter([1000, 1042])
    monkeypatch.setattr(api, "minor_faults", lambda: next(reads))
    (root,) = _traced_calls([_wav()])
    assert root["attrs"]["minflt"] == 42

    def unread():
        raise AssertionError("minor_faults read while nothing records")

    monkeypatch.setattr(api, "minor_faults", unread)
    assert api.wav_to_xa(_wav(), BITS, device="cpu") == api.encode_pcm(
        np.frombuffer(_wav()[RIFF_HEADER_SIZE:], "<i2").reshape(
            -1, CHANNELS), 44100, BITS, device="cpu")


def test_minor_faults_reads_the_threads_count():
    """The thread's own count, never falling; touching fresh pages raises
    it where the kernel counts faults."""
    import resource

    before = prof.minor_faults()
    fresh = np.ones(16 << 20, np.uint8)
    after = prof.minor_faults()
    assert type(before) is int and 0 <= before <= after
    assert after <= resource.getrusage(resource.RUSAGE_THREAD).ru_minflt
    assert fresh.sum() == 16 << 20


def test_records_lie_inside_their_ranges(run):
    """A record's interval lies inside its own range in the trace, so a
    stage's time leaves out the cost of the range itself."""
    ranges = defaultdict(list)
    for e in run["events"]:
        ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for r in run["records"]:
        assert any(a <= r["start_ns"] <= r["end_ns"] <= b
                   for a, b in ranges[r["name"]]), r["name"]


def test_rounds_equal_the_host_loop(run):
    """The search span's rounds (a tensor until the call's root closed)
    are the host loop's count for the same input."""
    body = run["wav"][RIFF_HEADER_SIZE:]
    pcm = np.zeros((BLOCKS * 32, CHANNELS), np.int16)
    pcm[:SAMPLES] = np.frombuffer(body, "<i2").reshape(-1, CHANNELS)
    lanes = torch.from_numpy(pcm.reshape(BLOCKS, 32, CHANNELS))
    *_, rounds = encode.encode_search_fixpoint(
        lanes, torch.zeros((CHANNELS, 2), dtype=torch.int32), bits=BITS,
        num_chunks=encode.pick_encode_chunks(BLOCKS, CHANNELS),
        run=lambda x, s: cuda_encode.encode_search_lanes_plain(x, s,
                                                               bits=BITS))
    got = [r["attrs"]["rounds"] for r in run["records"]
           if r["name"] == "bjxa.ops.search"]
    assert rounds > 1 and got == [rounds] * CALLS
    assert all(type(g) is int for g in got)


def test_searched_counts_the_starts_that_moved(run):
    """The search span's ``searched``: every chunk item in the first round,
    then those whose start the round before moved; ``items`` is K x C."""
    body = run["wav"][RIFF_HEADER_SIZE:]
    pcm = np.zeros((BLOCKS * 32, CHANNELS), np.int16)
    pcm[:SAMPLES] = np.frombuffer(body, "<i2").reshape(-1, CHANNELS)
    K = encode.pick_encode_chunks(BLOCKS, CHANNELS)
    starts = []

    def run_round(x, states):
        starts.append(states.clone())
        return cuda_encode.encode_search_lanes_plain(x, states, bits=BITS)

    *_, rounds = encode.encode_search_fixpoint(
        torch.from_numpy(pcm.reshape(BLOCKS, 32, CHANNELS)),
        torch.zeros((CHANNELS, 2), dtype=torch.int32), bits=BITS,
        num_chunks=K, run=run_round)
    moved = sum(int((b != a).any(dim=1).sum())
                for a, b in zip(starts, starts[1:]))
    got = [r["attrs"] for r in run["records"]
           if r["name"] == "bjxa.ops.search"]
    assert got == [{"rounds": rounds, "searched": K * CHANNELS + moved,
                    "items": K * CHANNELS}] * CALLS
    assert K * CHANNELS + moved < K * CHANNELS * rounds


def test_recording_agrees_with_the_profilers_own_state():
    """Either check of the flag (the module's, or the fallback where a
    torch lacks it) answers the same, off and on."""
    assert prof.recording() is torch._C._autograd._profiler_enabled() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert prof.recording() and torch._C._autograd._profiler_enabled()
    assert not prof.recording()


def test_span_falls_back_to_record_function(monkeypatch):
    """Where a torch lacks the cheaper range, the span is a
    ``record_function`` range, its record inside it."""
    monkeypatch.setattr(prof, "_Range", record_function)
    prof.clear()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("bjxa.fallback"):
            pass
    (rec,) = prof.records()
    (event,) = [e for e in p.profiler.kineto_results.events()
                if e.name() == "bjxa.fallback"]
    assert event.is_user_annotation()
    assert (event.start_ns() <= rec["start_ns"] <= rec["end_ns"]
            <= event.start_ns() + event.duration_ns())
    prof.clear()


def test_counters_span_keeps_stage_ms_and_traces():
    c = prof.Counters()
    prof.clear()
    with c.span("stage"):
        pass
    assert set(c.stage_ms) == {"stage"} and prof.records() == []
    off_ms = c.stage_ms["stage"]
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with c.span("stage"):
            pass
        with c.span("write"):
            pass
    assert set(c.stage_ms) == {"stage", "write"}
    assert c.stage_ms["stage"] > off_ms
    assert [r["name"] for r in prof.records()] == ["bjxa.corpus.stage",
                                                  "bjxa.corpus.write"]
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert {"bjxa.corpus.stage", "bjxa.corpus.write"} <= names
    prof.clear()


def test_stage_times_leave_out_the_ranges_cost(monkeypatch):
    """With a range that takes 50 ms to open and to close, neither a
    span's interval nor ``Counters.stage_ms`` holds that time."""

    class SlowRange:
        def __init__(self, name):
            self.inner = record_function(name)

        def __enter__(self):
            time.sleep(0.05)
            self.inner.__enter__()

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            time.sleep(0.05)

    monkeypatch.setattr(prof, "_Range", SlowRange)
    c = prof.Counters()
    prof.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with c.span("stage"):
            pass
    (rec,) = prof.records()
    assert rec["name"] == "bjxa.corpus.stage"
    assert rec["end_ns"] - rec["start_ns"] < 25_000_000
    assert c.stage_ms["stage"] < 25.0
    prof.clear()


def test_tensor_attribute_read_when_its_root_closes():
    prof.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("bjxa.root"):
            with prof.span("bjxa.child") as child:
                child.set(n=torch.tensor([7], dtype=torch.int32))
            (kept,) = prof.records()
            assert isinstance(kept["attrs"]["n"], torch.Tensor)
    child, root = prof.records()
    assert child["attrs"] == {"n": 7} and type(child["attrs"]["n"]) is int
    assert root["attrs"] == {}
    assert child["parent"] == root["id"] == child["request"]
    prof.clear()


def test_store_keeps_at_most_its_cap(monkeypatch):
    prof.clear()
    monkeypatch.setattr(prof, "MAX_RECORDS", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with prof.span("bjxa.x"):
                pass
    assert len(prof.records()) == 2 and prof.dropped() == 1
    prof.clear()
    assert prof.records() == [] and prof.dropped() == 0


def test_profiler_trace_clears_the_store_and_carries_spans(tmp_path):
    prof.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("bjxa.before"):
            pass
    with prof.Profiler(str(tmp_path)).trace():
        with prof.span("bjxa.inside"):
            pass
    assert [r["name"] for r in prof.records()] == ["bjxa.inside"]
    trace = json.loads((tmp_path / prof.TRACE_FILE).read_text())
    assert "bjxa.inside" in {e.get("name") for e in trace["traceEvents"]}
    prof.clear()


def test_each_thread_has_its_own_requests():
    prof.clear()
    go = threading.Barrier(2, timeout=30)

    def work():
        go.wait()
        with prof.span("bjxa.root"):
            with prof.span("bjxa.child"):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    requests = _requests(prof.records())
    assert len(requests) == 2
    for recs in requests.values():
        root = next(r for r in recs if r["name"] == "bjxa.root")
        child = next(r for r in recs if r["name"] == "bjxa.child")
        assert child["parent"] == root["id"] and root["parent"] is None
        assert child["thread"] == root["thread"]
    prof.clear()


def test_tensor_attribute_of_a_failed_request_reads_none():
    prof.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with prof.span("bjxa.root"):
                with prof.span("bjxa.child") as child:
                    child.set(n=torch.tensor([7]), m=3)
                raise ValueError("the call failed")
        with prof.span("bjxa.next"):
            pass
    child, root, after = prof.records()
    assert child["attrs"] == {"n": None, "m": 3}
    assert root["end_ns"] >= child["end_ns"]
    assert after["attrs"] == {}
    prof.clear()
