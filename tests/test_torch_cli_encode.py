"""The PyTorch port's ``encode`` CLI against :mod:`bjxa_tpu.cli`, both on
the CPU (``BJXA_PLATFORM=cpu``): same exit code, stdout bytes and stderr,
on the search and truncation encoders, the file and ``-`` conventions, and
every error path the one-shot encoder has (the cases of
``tests/test_cli.py`` that apply to it).

Streams stay under 2048 blocks, so the JAX CLI takes its single-device
path on the test harness's virtual CPU mesh.
"""

import numpy as np
import pytest
import torch

from bjxa_tpu import cli as jcli
from bjxa_tpu_torch import dump_riff_header, parse_xa_header
from bjxa_tpu_torch import cli as tcli
from test_torch_cli import run_cli


def make_wav(channels, frames, seed, rate=44100):
    """A canonical WAVE image of a seeded sine-plus-noise stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None]
    sig = 9000 * np.sin(2 * np.pi * t / (41.0 + 7 * np.arange(channels)))
    sig += rng.normal(0, 1500, size=(frames, channels))
    pcm = np.clip(sig, -32768, 32767).astype("<i2")
    return dump_riff_header(pcm.size * 2, rate, channels) + pcm.tobytes()


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.delenv("BJXA_DEVICES", raising=False)
    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)


def both(args, stdin=b""):
    return run_cli(tcli.main, args, stdin), run_cli(jcli.main, args, stdin)


STREAMS = {
    # name -> (flags, wav): fixpoint-length (>= 64 blocks) and short streams
    "default_stereo": ([], lambda: make_wav(2, 80 * 32 + 11, seed=1)),
    "bits4_mono": (["--bits", "4"], lambda: make_wav(1, 100 * 32, seed=2)),
    "bits8_stereo": (["--bits", "8"], lambda: make_wav(2, 23 * 32 - 7,
                                                       seed=3)),
    "truncate_mono": (["--truncate"], lambda: make_wav(1, 70 * 32 + 1,
                                                       seed=4)),
    "truncate_bits4": (["--truncate", "--bits", "4"],
                       lambda: make_wav(2, 300, seed=5)),
    "one_frame": (["--bits", "6"], lambda: make_wav(1, 1, seed=6)),
    "trailing_bytes": ([], lambda: make_wav(2, 200, seed=7) + b"\x01" * 9),
    "truncated_blocks": ([], lambda: make_wav(2, 90 * 32, seed=8)[:-3001]),
    "truncated_search_short": (["--bits", "4"],
                               lambda: make_wav(1, 40 * 32, seed=9)[:44 + 70]),
    "truncated_no_block": ([], lambda: make_wav(2, 64, seed=10)[:44 + 100]),
    "truncated_partial_frame": (["--truncate"],
                                lambda: make_wav(2, 99, seed=11)[:-1]),
    "truncated_empty_body": ([], lambda: make_wav(1, 50, seed=12)[:44]),
    "empty_data": ([], lambda: dump_riff_header(0, 44100, 1)),
    "short_header": ([], lambda: b"RIFF"),
    "bad_header": ([], lambda: b"JUNK" + bytes(40)),
    "bad_channels": ([], lambda: (
        lambda w: w[:22] + b"\x03" + w[23:])(make_wav(1, 64, seed=13))),
    "empty_input": ([], lambda: b""),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_encode_stdin_stdout_matches(cpu_platform, name):
    flags, make = STREAMS[name]
    data = make()
    got, want = both(["encode", *flags, "-", "-"], data)
    assert got == want
    if name == "default_stereo":
        assert got[0] == 0 and got[2] == ""
        fmt = parse_xa_header(got[1])
        assert (fmt.bits, fmt.channels, fmt.samples) == (6, 2, 80 * 32 + 11)
    if name.startswith("truncated"):
        assert got[0] == 1 and got[2] == "fread: End of file\n"


@pytest.mark.parametrize("flags", [[], ["--bits", "8", "--truncate"]])
def test_encode_files_match(cpu_platform, tmp_path, flags):
    """Named files in and out, and the omitted-output form (stdout)."""
    src = tmp_path / "in.wav"
    src.write_bytes(make_wav(2, 75 * 32 + 3, seed=20))
    runs = []
    for main, out in ((tcli.main, "t.xa"), (jcli.main, "j.xa")):
        runs.append(run_cli(main, ["encode", *flags, str(src),
                                   str(tmp_path / out)]))
    assert runs[0] == runs[1] == (0, b"", "")
    assert (tmp_path / "t.xa").read_bytes() == (tmp_path / "j.xa").read_bytes()
    got, want = both(["encode", *flags, str(src)])
    assert got == want and got[1] == (tmp_path / "t.xa").read_bytes()


@pytest.mark.parametrize("args", [
    ["encode", "--bits"],
    ["encode", "--bits", "5"],
    ["encode", "--bits", "8001"],
    ["encode", "--bits", "x"],
    ["encode", "a", "b", "c"],
    ["encode", "--bits", "4", "a", "b", "c"],
    ["encode", "--truncate", "a", "b", "c"],
], ids=["missing_bits", "bits5", "bits8001", "bits_x", "too_many",
        "too_many_after_bits", "too_many_after_truncate"])
def test_encode_usage_errors_match(cpu_platform, args):
    """Same exit code and error label; the usage text that follows lists
    only the actions this port has."""
    (tc, tout, terr), (jc, jout, jerr) = both(args)
    assert tc == jc == 1 and tout == jout == b""
    assert terr.split("\n")[0] == jerr.split("\n")[0]
    assert "encode [--bits <4|6|8>] [--truncate]" in terr


def test_encode_missing_input_matches(cpu_platform, tmp_path):
    got, want = both(["encode", str(tmp_path / "nope.wav")])
    assert got == want and got[0] == 1
    assert got[2].startswith("Error: ")


def test_encode_unwritable_output_matches(cpu_platform, tmp_path):
    wav = make_wav(1, 40, seed=1)
    got, want = both(["encode", "-", str(tmp_path / "no/dir/out.xa")], wav)
    assert got == want and got[0] == 1


@pytest.mark.parametrize("flag", ["--devices", "--segment-blocks"])
def test_unported_encode_flags_fail(cpu_platform, monkeypatch, tmp_path,
                                    flag):
    """Both encode options answer as bjxa_tpu's CLI does.
    ``--segment-blocks``: a missing input, and a segmented encode's bytes
    after ``--bits``.  ``--devices`` (eight CPU entries against the JAX
    package's eight devices): 1 and 2 encode the same bytes, 0 is refused
    with the usage, 9 and a bad ``BJXA_DEVICES`` exit 1 with one line."""
    if flag == "--devices":
        monkeypatch.setattr(tcli, "_local_devices",
                            lambda: [torch.device("cpu")] * 8)
        wav = make_wav(2, 70 * 32 + 5, seed=41)
        for args in (["encode", flag, "1"], ["encode", "--bits", "4", flag,
                                             "2"]):
            got, want = both(args, wav)
            assert got == want and got[0] == 0, args
            assert got == run_cli(tcli.main, [a for a in args if a not in
                                              (flag, "1", "2")], wav)
        got, want = both(["encode", flag, "0", "x.wav"])
        assert got[0] == want[0] == 1 and got[1] == want[1] == b""
        assert got[2].split("\n")[0] == want[2].split("\n")[0] == (
            "bjxa: Invalid --devices")
        got, want = both(["encode", "--truncate", flag, "9"], wav)
        assert got == want == (
            1, b"", "bjxa: --devices 9 out of range (1..8 available)\n")
        monkeypatch.setenv("BJXA_DEVICES", "x")
        got, want = both(["encode"], wav)
        assert got == want == (1, b"", "bjxa: Invalid BJXA_DEVICES 'x'\n")
        return
    monkeypatch.setenv("BJXA_DEVICES", "1")  # one device in both CLIs
    got, want = both(["encode", flag, "2", str(tmp_path / "x.wav")])
    assert got == want and got[0] == 1 and got[2].startswith("Error: ")
    wav = make_wav(2, 70 * 32 + 5, seed=40)
    got, want = both(["encode", "--bits", "4", flag, "32"], wav)
    assert got == want and got[0] == 0
    assert got == run_cli(tcli.main, ["encode", "--bits", "4"], wav)


def test_encode_without_cuda_refuses_to_run(monkeypatch):
    """Without a card and without BJXA_PLATFORM=cpu the encoder exits 1
    and says why: it never encodes on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    code, out, err = run_cli(tcli.main, ["encode", "-", "-"],
                             make_wav(1, 64, seed=1))
    assert code == 1 and out == b""
    assert err == ("bjxa: CUDA is not available; set BJXA_PLATFORM=cpu to"
                   " encode on the CPU\n")


def test_encode_decode_round_trip(cpu_platform):
    """The port's decode of the port's encode: a canonical WAVE of the
    same length, as ``tests/test_cli.py::test_encode_decode_roundtrip``
    checks for the JAX CLI."""
    wav = make_wav(2, 66 * 32 + 5, seed=30)
    code, xa, err = run_cli(tcli.main, ["encode", "--bits", "8"], wav)
    assert (code, err) == (0, "") and xa[:4] == b"KWD1"
    code, out, err = run_cli(tcli.main, ["decode"], xa)
    assert (code, err) == (0, "")
    assert out[:44] == wav[:44] and len(out) == len(wav)
