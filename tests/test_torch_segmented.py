"""The PyTorch port's segmented bounded-memory decode and encode against
:mod:`bjxa_tpu`, both on the CPU, case for case with
``tests/test_segmented.py``: the same seeded streams go through
``iter_decode_segments`` / ``iter_encode_segments``, the stream API, the CLI
and the corpus engine's oversized-file route of both packages.  Exact
comparison: bytes, segment boundaries, messages, exit codes, stderr.
"""

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bjxa_tpu import api as japi
from bjxa_tpu import cli as jcli
from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu.ops import encode as jencode
from bjxa_tpu.parallel import corpus as jcorpus
from bjxa_tpu_torch import (
    XA_HEADER_SIZE,
    BjxaProtocolError,
    XAFormat,
    decode_xa_stream,
    dump_pcm,
    dump_riff_header,
    dump_xa_header,
    encode_pcm,
    encode_wav_stream,
    parse_xa_header,
    wav_to_xa,
    xa_to_wav,
)
from bjxa_tpu_torch import api as tapi
from bjxa_tpu_torch import cli as tcli
from bjxa_tpu_torch.ops import decode as tdecode
from bjxa_tpu_torch.ops import encode as tencode
from bjxa_tpu_torch.parallel import corpus as tcorpus
from test_torch_cli import run_cli

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture
def one_device(monkeypatch):
    """Both CLIs on the CPU, the JAX one on a single device (the harness
    gives it 8 virtual ones, which it would shard segments over)."""
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.setenv("BJXA_DEVICES", "1")
    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    monkeypatch.delenv("BJXA_SEGMENT_THRESHOLD", raising=False)


def both_cli(args, stdin=b""):
    """``args`` through the port's CLI (which has no ``BJXA_DEVICES``) and
    through :mod:`bjxa_tpu.cli`."""
    return run_cli(tcli.main, args, stdin), run_cli(jcli.main, args, stdin)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(0)
    sig = rng.integers(-25000, 25000, size=(700 * 32, 2)).astype(np.int16)
    xa = encode_pcm(sig, 44100, 6, search=False, device=CPU)
    fmt = parse_xa_header(xa)
    payload = xa[XA_HEADER_SIZE:]
    return fmt, payload, tdecode.decode_bytes(payload, fmt, device=CPU)


def jax_fmt(fmt):
    """The same header fields as a :class:`bjxa_tpu.format.xa.XAFormat`
    (the emitted header carries zero seeds, so no round trip through it)."""
    import dataclasses

    from bjxa_tpu.format.xa import XAFormat as JaxFormat

    return JaxFormat(**{f.name: getattr(fmt, f.name)
                        for f in dataclasses.fields(fmt)})


def segments(payload, fmt, segment_blocks):
    """Both packages' segment lists for one payload, with what they
    raised."""
    out = []
    for it in (
        tdecode.iter_decode_segments(io.BytesIO(payload).read, fmt,
                                     device=CPU,
                                     segment_blocks=segment_blocks),
        jdecode.iter_decode_segments(io.BytesIO(payload).read, jax_fmt(fmt),
                                     segment_blocks=segment_blocks),
    ):
        parts, raised = [], None
        try:
            for p in it:
                parts.append(np.asarray(p))
        except Exception as e:  # noqa: BLE001 - compared below, by type
            raised = (type(e).__name__, str(e))
        out.append((parts, raised))
    return out


def assert_same_segments(got, want):
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("segment_blocks", [96, 700, 701, 1])
def test_segmented_bit_exact(stream, segment_blocks):
    """Any segment size reproduces the one-shot bytes exactly, segment by
    segment as bjxa_tpu yields them."""
    fmt, payload, ref = stream
    got, want = segments(payload, fmt, segment_blocks)
    assert got[1] is None
    assert_same_segments(got, want)
    np.testing.assert_array_equal(np.concatenate(got[0]), ref)
    assert len(got[0]) == -(-700 // segment_blocks)


def test_segmented_nonzero_header_state():
    """Header predictor seeds feed the first segment's anchor state."""
    rng = np.random.default_rng(3)
    nblocks, size = 40, 25
    raw = rng.integers(0, 256, size=(nblocks, 1, size), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(nblocks, 1)) << 4) | (
        rng.integers(0, 4, size=(nblocks, 1))
    )
    fmt = XAFormat(
        data_len=nblocks * size, samples=nblocks * 32, samples_rate=44100,
        bits=6, channels=1, initial_state=((1234, -567), (0, 0)),
    )
    payload = raw.tobytes()
    ref = tdecode.decode_bytes(payload, fmt, device=CPU)
    got, want = segments(payload, fmt, 7)
    assert_same_segments(got, want)
    np.testing.assert_array_equal(np.concatenate(got[0]), ref)


def test_segmented_invalid_profile_prefix(stream):
    """An invalid profile in a later segment yields the exact valid prefix
    BEFORE the raise, which names the absolute block index."""
    fmt, payload, ref = stream
    bad = bytearray(payload)
    bad_block = 3 * 96 + 10
    bad[bad_block * fmt.block_size_xa] = 0xF0  # factor 15
    got, want = segments(bytes(bad), fmt, 96)
    assert_same_segments(got, want)
    assert got[1] == (
        "BjxaProtocolError",
        f"invalid block profile factor in block {bad_block} channel 0",
    )
    np.testing.assert_array_equal(np.concatenate(got[0]),
                                  ref[: bad_block * 32])
    out = []
    with pytest.raises(BjxaProtocolError):
        for p in tdecode.iter_decode_segments(
            io.BytesIO(bytes(bad)).read, fmt, device=CPU, segment_blocks=96
        ):
            out.append(p)
    assert sum(len(p) for p in out) == bad_block * 32


def test_segmented_truncated_prefix(stream):
    """Truncation mid-segment decodes the complete blocks present, then
    raises EOFError (the CLI prints the reference's fread label)."""
    fmt, payload, ref = stream
    cut = (2 * 96 + 5) * fmt.block_size_xa + 7
    got, want = segments(payload[:cut], fmt, 96)
    assert_same_segments(got, want)
    assert got[1] == ("EOFError", "truncated XA stream")
    np.testing.assert_array_equal(np.concatenate(got[0]),
                                  ref[: (2 * 96 + 5) * 32])
    # nothing at all after the header: no segment, the same error
    got, want = segments(b"", fmt, 96)
    assert got == want == ([], ("EOFError", "truncated XA stream"))


def test_segmented_short_sample_count():
    """A header whose ``samples`` stops inside the last block: the tail
    segment is trimmed to it."""
    rng = np.random.default_rng(4)
    sig = rng.integers(-20000, 20000, size=(130 * 32 - 11, 1)).astype(np.int16)
    xa = encode_pcm(sig, 22050, 4, search=False, device=CPU)
    fmt = parse_xa_header(xa)
    got, want = segments(xa[XA_HEADER_SIZE:], fmt, 64)
    assert_same_segments(got, want)
    assert sum(len(p) for p in got[0]) == 130 * 32 - 11


def test_cli_segmented_matches_oneshot(one_device, stream):
    """`decode --segment-blocks` produces byte-identical WAV output, the
    one bjxa_tpu's CLI gives."""
    fmt, payload, _ = stream
    xa = dump_xa_header(fmt) + payload
    code, one, err = run_cli(tcli.main, ["decode"], stdin=xa)
    assert code == 0, err
    got, want = both_cli(["decode", "--segment-blocks", "128"], stdin=xa)
    assert got == want
    assert got == (0, one, "")


def test_cli_auto_segments_above_threshold(one_device, monkeypatch, stream):
    """Without the flag, a file above ``segment_threshold()`` takes the
    segmented route (65,536-block segments) and gives the same bytes."""
    fmt, payload, _ = stream
    xa = dump_xa_header(fmt) + payload
    calls = []
    real = tapi.decode_xa_stream

    def spy(*a, **kw):
        calls.append(kw["segment_blocks"])
        return real(*a, **kw)

    monkeypatch.setattr(tapi, "decode_xa_stream", spy)
    code, one, err = run_cli(tcli.main, ["decode"], stdin=xa)
    assert (code, err, calls) == (0, "", [])
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "1000")
    got, want = both_cli(["decode"], stdin=xa)
    assert got == want == (0, one, "")
    assert calls == [tdecode.SEGMENT_BLOCKS] == [jdecode.SEGMENT_BLOCKS]


def _child_rss_kb(args, env):
    """Run the port's CLI in a child process; (exit, its peak RSS in KiB,
    sampled from here while it runs)."""
    from bjxa_tpu_torch.benchmarks._common import PeakRss

    child = subprocess.Popen(
        [sys.executable, "-m", "bjxa_tpu_torch", *args], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    with PeakRss(child.pid) as rss:
        _out, err = child.communicate(timeout=560)
    assert rss.peak_mb > 0, err
    return child.returncode, int(rss.peak_mb * 1024)


def test_segmented_decode_bounded_rss(tmp_path):
    """Peak RSS of a segmented big-file decode stays far below the file's
    payload + PCM footprint.

    The big file is ~16 MB of XA / ~84 MB of PCM; a ~0.8 MB control file
    decoded by the same child-process flow measures the interpreter + torch
    baseline, so the difference is per-file memory: O(segment), not O(file).
    """
    rng = np.random.default_rng(9)
    seg = 8192
    nblocks = 40 * seg  # 327,680 blocks: 16.4 MB payload, 83.9 MB PCM
    size = 25

    def make(path, nb):
        raw = rng.integers(0, 256, size=(nb, 2, size), dtype=np.uint8)
        raw[:, :, 0] = (rng.integers(0, 5, size=(nb, 2)) << 4) | (
            rng.integers(0, 4, size=(nb, 2))
        )
        fmt = XAFormat(
            data_len=nb * 2 * size, samples=nb * 32, samples_rate=44100,
            bits=6, channels=2, initial_state=((0, 0), (0, 0)),
        )
        path.write_bytes(dump_xa_header(fmt) + raw.tobytes())

    big = tmp_path / "big.xa"
    small = tmp_path / "small.xa"
    make(big, nblocks)
    make(small, 2 * seg)
    env = dict(os.environ, BJXA_PLATFORM="cpu", PYTHONPATH=str(REPO))

    def run(path):
        out = tmp_path / "out.wav"
        code, rss = _child_rss_kb(
            ["decode", "--segment-blocks", str(seg), str(path), str(out)],
            env)
        assert code == 0
        return rss, out.stat().st_size

    rss_small, _ = run(small)
    rss_big, wav_bytes = run(big)
    assert wav_bytes == 44 + nblocks * 32 * 2 * 2
    assert rss_big - rss_small < 30 * 1024, (rss_big, rss_small)


# -- segmented encode (the encode mirror) -----------------------------------


def encode_segments(body, channels, nsamples, *, search, segment_blocks=96):
    out = []
    for it in (
        tencode.iter_encode_segments(
            io.BytesIO(body).read, channels, nsamples, bits=6, search=search,
            device=CPU, segment_blocks=segment_blocks),
        jencode.iter_encode_segments(
            io.BytesIO(body).read, channels, nsamples, bits=6, search=search,
            segment_blocks=segment_blocks),
    ):
        parts, raised = [], None
        try:
            for p in it:
                parts.append(bytes(p))
        except EOFError as e:
            raised = str(e)
        out.append((parts, raised))
    return out


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("nsamples", [700 * 32, 700 * 32 - 13])
def test_segmented_encode_bit_exact(search, nsamples):
    """Segmented encode carries the exact search state between segments:
    bytes identical to the one-shot encoder and to bjxa_tpu's segments,
    including the zero-padded partial final block."""
    rng = np.random.default_rng(nsamples + search)
    pcm = rng.integers(-25000, 25000, size=(nsamples, 2)).astype(np.int16)
    want_xa = encode_pcm(pcm, 44100, 6, search=search, device=CPU)
    got, want = encode_segments(pcm.astype("<i2").tobytes(), 2, nsamples,
                                search=search)
    assert got == want and got[1] is None
    assert b"".join(got[0]) == want_xa[XA_HEADER_SIZE:]


def test_segmented_encode_truncated_matches_streaming():
    """A truncated PCM stream yields exactly the whole blocks present (the
    streaming encoder's contract), then raises EOFError."""
    rng = np.random.default_rng(5)
    nsamples = 4 * 96 * 32
    pcm = rng.integers(-25000, 25000, size=(nsamples, 1)).astype(np.int16)
    want_xa = encode_pcm(pcm, 44100, 6, search=True, device=CPU)
    cut_frames = 2 * 96 * 32 + 5 * 32 + 7
    body = pcm[:cut_frames].astype("<i2").tobytes() + b"\x01"
    got, want = encode_segments(body, 1, nsamples, search=True)
    assert got == want and got[1] == "truncated PCM stream"
    whole = cut_frames // 32
    assert b"".join(got[0]) == want_xa[
        XA_HEADER_SIZE: XA_HEADER_SIZE + whole * 25]


def test_cli_segmented_encode_matches_oneshot(one_device):
    """`encode --segment-blocks` produces byte-identical XA output, and a
    truncated body matches the non-segmented truncated path; both as
    bjxa_tpu's CLI answers."""
    rng = np.random.default_rng(8)
    pcm = rng.integers(-20000, 20000, size=(500 * 32 - 9, 2)).astype(np.int16)
    wav = dump_riff_header(pcm.size * 2, 44100, 2) + dump_pcm(pcm)
    code, one, err = run_cli(tcli.main, ["encode"], stdin=wav)
    assert code == 0, err
    got, want = both_cli(["encode", "--segment-blocks", "128"], stdin=wav)
    assert got == want == (0, one, "")

    cut = wav[: 44 + (300 * 32 + 11) * 4 + 2]
    code, one_t, err1 = run_cli(tcli.main, ["encode"], stdin=cut)
    assert code == 1 and "End of file" in err1
    got, want = both_cli(["encode", "--segment-blocks", "128"], stdin=cut)
    assert got == want == (1, one_t, "fread: End of file\n")

    got, want = both_cli(
        ["encode", "--truncate", "--bits", "4", "--segment-blocks", "50"],
        stdin=wav)
    assert got == want and got[0] == 0
    assert got[1] == wav_to_xa(wav, 4, search=False, device=CPU)


def test_cli_segmented_decode_error_paths(one_device, stream):
    """Segmented CLI decode reports truncation and bad profiles with the
    reference's labels and byte-matches the non-segmented error paths and
    bjxa_tpu's CLI."""
    fmt, payload, _ = stream
    xa = dump_xa_header(fmt) + payload

    cut = xa[: 32 + 96 * fmt.block_size_xa + 3]
    got, want = both_cli(["decode", "--segment-blocks", "96"], stdin=cut)
    assert got == want
    assert got[0] == 1 and got[2] == "fread: End of file\n"
    code, one, _ = run_cli(tcli.main, ["decode"], stdin=cut)
    assert code == 1 and got[1] == one

    bad = bytearray(xa)
    bad[32 + (96 + 5) * fmt.block_size_xa] = 0xF0
    got, want = both_cli(["decode", "--segment-blocks", "96"],
                         stdin=bytes(bad))
    assert got == want
    assert got[0] == 1 and got[2] == "bjxa_decode: Protocol error\n"
    code, one, _ = run_cli(tcli.main, ["decode"], stdin=bytes(bad))
    assert code == 1 and got[1] == one


@pytest.mark.parametrize("args", [
    ["decode", "--segment-blocks"], ["decode", "--segment-blocks", "0"],
    ["decode", "--segment-blocks", "x", "a.xa"],
    ["encode", "--segment-blocks"], ["encode", "--segment-blocks", "-3"],
    ["encode", "--bits", "4", "--segment-blocks", "1.5"],
], ids=lambda a: "_".join(a))
def test_cli_segment_blocks_option_errors_match(one_device, args):
    (tc, tout, terr), (jc, jout, jerr) = both_cli(args)
    assert tc == jc == 1 and tout == jout == b""
    assert terr.split("\n")[0] == jerr.split("\n")[0] == (
        "bjxa: Invalid --segment-blocks")


def test_stream_api_parses_own_headers():
    """The public stream API parses container headers itself when none is
    pre-supplied, matching the one-shot byte converters and bjxa_tpu's
    stream API exactly."""
    rng = np.random.default_rng(81)
    pcm = rng.integers(-20000, 20000, size=(200 * 32 - 5, 2)).astype(np.int16)
    wav = dump_riff_header(pcm.size * 2, 44100, 2) + dump_pcm(pcm)

    out, jout = io.BytesIO(), io.BytesIO()
    fmt = encode_wav_stream(io.BytesIO(wav), out, 6, search=False,
                            segment_blocks=64, device=CPU)
    jfmt = japi.encode_wav_stream(io.BytesIO(wav), jout, 6, search=False,
                                  segment_blocks=64)
    assert out.getvalue() == jout.getvalue()
    assert out.getvalue() == wav_to_xa(wav, 6, search=False, device=CPU)
    assert fmt.samples == pcm.shape[0]
    assert dump_xa_header(fmt) == dump_xa_header(jax_fmt(fmt))
    assert (fmt.data_len, fmt.blocks) == (jfmt.data_len, jfmt.blocks)

    xa = out.getvalue()
    out2, jout2 = io.BytesIO(), io.BytesIO()
    got_fmt = decode_xa_stream(io.BytesIO(xa), out2, segment_blocks=64,
                               device=CPU)
    japi.decode_xa_stream(io.BytesIO(xa), jout2, segment_blocks=64)
    assert out2.getvalue() == jout2.getvalue() == xa_to_wav(xa, device=CPU)
    assert got_fmt == parse_xa_header(xa)


# -- the corpus engine's oversized files ------------------------------------


def _counts(res):
    c = res.counters
    return (res.converted, res.skipped, res.failed,
            (c.files, c.blocks, c.samples, c.bytes_in, c.bytes_out))


def _files(d, pattern):
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


def test_corpus_oversized_files_take_the_segmented_route(tmp_path,
                                                         monkeypatch):
    """With ``BJXA_SEGMENT_THRESHOLD`` lowered, big files go through
    ``decode_xa_stream`` (small ones still batch), with bjxa_tpu's bytes,
    counters and failure messages, a bad profile among them."""
    from test_torch_corpus import make_xa

    src = tmp_path / "src"
    src.mkdir()
    (src / "big.xa").write_bytes(make_xa(6, 2, 300, seed=1))
    (src / "big_mono.xa").write_bytes(make_xa(4, 1, 500, seed=2))
    (src / "small.xa").write_bytes(make_xa(6, 2, 9, seed=3))
    (src / "bad.xa").write_bytes(make_xa(8, 2, 200, seed=4, bad=(150, 1)))
    streamed = []
    real = tcorpus.decode_xa_stream

    def spy(fin, fout, fmt, **kw):
        streamed.append(fmt.blocks)
        return real(fin, fout, fmt, **kw)

    monkeypatch.setattr(tcorpus, "decode_xa_stream", spy)
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "20000")
    res = tcorpus.decode_corpus(src, tmp_path / "t", device=CPU)
    want = jcorpus.decode_corpus(src, tmp_path / "j")
    assert sorted(streamed) == [200, 300, 500]
    assert _counts(res) == _counts(want)
    assert res.converted == 3 and res.failed == {
        str(src / "bad.xa"):
            "invalid block profile factor in block 150 channel 1"}
    assert _files(tmp_path / "t", "*.wav") == _files(tmp_path / "j", "*.wav")
    assert "segmented" in res.counters.stage_ms
    assert not list((tmp_path / "t").glob("*.tmp"))


def test_corpus_oversized_wavs_take_the_segmented_route(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(6)
    for name, (ch, frames) in {"big": (2, 150 * 32 - 3), "big_mono": (1, 4000),
                               "small": (2, 40)}.items():
        pcm = rng.integers(-20000, 20000, size=(frames, ch)).astype("<i2")
        (src / f"{name}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, ch) + pcm.tobytes())
    streamed = []
    real = tcorpus.encode_wav_stream

    def spy(fin, fout, bits, **kw):
        streamed.append(kw["rf"].samples)
        return real(fin, fout, bits, **kw)

    monkeypatch.setattr(tcorpus, "encode_wav_stream", spy)
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "5000")
    for search in (True, False):
        streamed.clear()
        res = tcorpus.encode_corpus(src, tmp_path / f"t{search}", device=CPU,
                                    search=search)
        want = jcorpus.encode_corpus(src, tmp_path / f"j{search}",
                                     search=search)
        assert sorted(streamed) == [4000, 150 * 32 - 3]
        assert _counts(res) == _counts(want) and res.converted == 3
        got = _files(tmp_path / f"t{search}", "*.xa")
        assert got == _files(tmp_path / f"j{search}", "*.xa")
        for name, xa in got.items():
            wav = (src / name.replace(".xa", ".wav")).read_bytes()
            assert xa == wav_to_xa(wav, 6, search=search, device=CPU)
