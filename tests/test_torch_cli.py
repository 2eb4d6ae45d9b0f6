"""The PyTorch port's CLI against :mod:`bjxa_tpu.cli`, both on the CPU
(``BJXA_PLATFORM=cpu``): same exit code, stdout bytes and stderr for the
decode surface, plus the port's own guarantees (no JAX import, no silent
CPU run without ``BJXA_PLATFORM=cpu``).

Streams stay under 2048 blocks, so the JAX CLI takes its single-device
path on the test harness's virtual CPU mesh.
"""

import io
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from bjxa_tpu import cli as jcli
from bjxa_tpu_torch import (
    XAFormat,
    dump_riff_header,
    dump_xa_header,
    parse_xa_header,
)
from bjxa_tpu_torch import cli as tcli

REPO = pathlib.Path(__file__).resolve().parent.parent


def make_xa(bits, channels, blocks, seed, bad_block=None):
    """A valid XA file image from a seed (see test_torch_decode)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(blocks, channels)) << 4
        | rng.integers(0, 13, size=(blocks, channels))
    ).astype(np.uint8)
    if bad_block is not None:
        raw[bad_block, channels - 1, 0] = 0x6F
    fmt = XAFormat(
        data_len=raw.size, samples=blocks * 32 - int(rng.integers(0, 32)),
        samples_rate=44100, bits=bits, channels=channels,
        initial_state=((0, 0), (0, 0)),
    )
    hdr = bytearray(dump_xa_header(fmt))
    struct.pack_into(
        "<4h", hdr, 20, *rng.integers(-(2**15), 2**15, 4).tolist()
    )
    return bytes(hdr) + raw.tobytes()


def run_cli(main, args, stdin=b""):
    """Invoke ``main`` with captured binary stdio; (code, out, err)."""
    out_buf = io.BytesIO()
    err = io.StringIO()

    class In:
        buffer = io.BytesIO(stdin)

    class Out:
        buffer = out_buf

        @staticmethod
        def write(s):
            out_buf.write(s.encode())

    old = sys.stdin, sys.stdout, sys.stderr
    sys.stdin, sys.stdout, sys.stderr = In(), Out(), err
    try:
        code = main(["bjxa"] + args)
    finally:
        sys.stdin, sys.stdout, sys.stderr = old
    return code, out_buf.getvalue(), err.getvalue()


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.delenv("BJXA_DEVICES", raising=False)


def both(args, stdin=b""):
    got = run_cli(tcli.main, args, stdin)
    want = run_cli(jcli.main, args, stdin)
    return got, want


STREAMS = {
    "stereo6": lambda: make_xa(6, 2, 300, seed=1),
    "mono4_short": lambda: make_xa(4, 1, 23, seed=2),
    "truncated": lambda: make_xa(8, 2, 150, seed=3)[:-700],
    "truncated_bad": lambda: make_xa(8, 1, 90, seed=4, bad_block=5)[:-100],
    "invalid_profile": lambda: make_xa(6, 2, 400, seed=5, bad_block=321),
    "invalid_short": lambda: make_xa(4, 2, 17, seed=6, bad_block=0),
    "short_header": lambda: make_xa(6, 1, 4, seed=7)[:20],
    "empty": lambda: b"",
    "bad_magic": lambda: b"KWD2" + make_xa(6, 1, 4, seed=8)[4:],
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_stdin_stdout_matches(cpu_platform, name):
    data = STREAMS[name]()
    got, want = both(["decode", "-", "-"], data)
    assert got == want
    if name == "stereo6":
        assert got[0] == 0
        assert len(got[1]) == 44 + parse_xa_header(data).data_len_pcm


def test_decode_files_match(cpu_platform, tmp_path):
    src = tmp_path / "in.xa"
    src.write_bytes(make_xa(8, 1, 120, seed=9))
    codes = []
    for main, out in ((tcli.main, "t.wav"), (jcli.main, "j.wav")):
        code, stdout, err = run_cli(main, ["decode", str(src),
                                           str(tmp_path / out)])
        codes.append((code, stdout, err))
    assert codes[0] == codes[1] == (0, b"", "")
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_decode_missing_input_matches(cpu_platform, tmp_path):
    got, want = both(["decode", str(tmp_path / "nope.xa")])
    assert got == want and got[0] == 1


@pytest.mark.parametrize(
    "args", [["decode", "a", "b", "c"], ["frobnicate"], [], ["help"]],
    ids=["too_many", "unknown", "none", "help"],
)
def test_usage_paths_match(cpu_platform, args):
    """Same exit code and error label; the usage text itself lists only
    the actions and options this port has."""
    (tc, tout, terr), (jc, jout, jerr) = both(args)
    assert tc == jc
    assert terr.split("\n")[0] == jerr.split("\n")[0]
    assert tout[:6] == jout[:6]
    usage = tout.decode() if args == ["help"] else terr
    assert ("decode [--streaming] [--segment-blocks <n>] [<xa file>"
            " [<wav file>]]" in usage)
    assert "encode [--bits <4|6|8>] [--truncate]" in usage
    assert ("corpus [--batch-files <n>] [--depth <k>] [--manifest <path>]"
            in usage)
    assert "  abi --install <prefix>\n" in usage
    assert "--devices" not in usage


@pytest.mark.parametrize("flag", ["--streaming", "--devices",
                                  "--segment-blocks"])
def test_unported_decode_flags_fail(cpu_platform, monkeypatch, tmp_path,
                                    flag):
    """``--devices`` is not ported and says so; ``--streaming`` and
    ``--segment-blocks`` are, and answer as bjxa_tpu's CLI does: a missing
    input, and the bytes and stderr of a valid, a cut and an
    invalid-profile stream, equal to the whole-file decode's."""
    if flag == "--streaming":
        got, want = both(["decode", flag, "2", str(tmp_path / "x.xa")])
        assert got == want and got[0] == 1 and got[2].startswith("Error: ")
        for name, data in STREAMS.items():
            got, want = both(["decode", flag, "-", "-"], data())
            assert got == want, name
            assert got == run_cli(tcli.main, ["decode"], data()), name
        return
    if flag == "--devices":
        code, out, err = run_cli(tcli.main, ["decode", flag, "2", "x.xa"])
        assert code == 1 and out == b""
        assert err.startswith(f"bjxa: {flag} is not yet ported\n")
        return
    monkeypatch.setenv("BJXA_DEVICES", "1")  # read by the JAX CLI alone
    got, want = both(["decode", flag, "2", str(tmp_path / "x.xa")])
    assert got == want and got[0] == 1 and got[2].startswith("Error: ")
    got, want = both(["decode", flag, "none", "x.xa"])
    assert got[0] == want[0] == 1 and got[1] == want[1] == b""
    assert got[2].split("\n")[0] == want[2].split("\n")[0]
    for name in ("stereo6", "truncated", "invalid_profile"):
        got, want = both(["decode", flag, "64", "-", "-"], STREAMS[name]())
        assert got == want
        assert got == run_cli(tcli.main, ["decode"], STREAMS[name]())


@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("name", ["stereo6", "truncated", "invalid_profile",
                                  "truncated_bad"])
def test_decode_streaming_files_match(cpu_platform, monkeypatch, tmp_path,
                                      native, name):
    """``decode --streaming`` between files, with the native library and
    under ``BJXA_NO_NATIVE``: the twins' exit code, stdio and WAV bytes."""
    if native == "off":
        monkeypatch.setenv("BJXA_NO_NATIVE", "1")
        from bjxa_tpu import native as jnative

        monkeypatch.setattr(jnative, "available", lambda: False)
    src = tmp_path / "in.xa"
    src.write_bytes(STREAMS[name]())
    runs = []
    for main, out in ((tcli.main, "t.wav"), (jcli.main, "j.wav")):
        runs.append(run_cli(main, ["decode", "--streaming", str(src),
                                   str(tmp_path / out)]))
    assert runs[0] == runs[1]
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_decode_streaming_needs_no_device(monkeypatch, tmp_path):
    """The streaming codec runs on the host: without a card and without
    ``BJXA_PLATFORM=cpu`` it still decodes, where the whole-file path
    refuses."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    data = STREAMS["stereo6"]()
    code, out, err = run_cli(tcli.main, ["decode", "--streaming"], data)
    assert (code, err) == (0, "")
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    assert run_cli(tcli.main, ["decode"], data) == (code, out, err)


@pytest.mark.parametrize(
    "args", [[], ["--install"], ["--frob", "x"], ["--install", "a", "b"]],
    ids=["none", "no_prefix", "unknown", "too_many"])
def test_abi_misuse_matches(cpu_platform, args):
    """``abi`` without exactly ``--install <prefix>``: exit 1 and the same
    error line (the usage below it lists each tool's own actions)."""
    (tc, tout, terr), (jc, jout, jerr) = both(["abi", *args])
    assert tc == jc == 1 and tout == jout == b""
    assert terr.split("\n")[0] == jerr.split("\n")[0] == (
        "bjxa: abi requires --install <prefix>")


def test_abi_install_matches(cpu_platform, tmp_path):
    """``abi --install``: the same roles on stdout, the same header and
    pkg-config file, a working installed CLI; an unusable prefix fails
    with the same label; ``BJXA_NO_NATIVE`` refuses in both."""
    runs = {}
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        prefix = tmp_path / tag
        code, out, err = run_cli(main, ["abi", "--install", str(prefix)])
        runs[tag] = (code, out.decode().replace(str(prefix), "<prefix>"),
                     err)
    assert runs["t"] == runs["j"]
    assert runs["t"][0] == 0 and runs["t"][1].split() == [
        "lib", "<prefix>/lib/libbjxa.so.0", "header",
        "<prefix>/include/bjxa.h", "pkgconfig",
        "<prefix>/lib/pkgconfig/bjxa.pc", "bin", "<prefix>/bin/bjxa"]
    for rel in ("include/bjxa.h",):
        assert ((tmp_path / "t" / rel).read_bytes()
                == (tmp_path / "j" / rel).read_bytes())
    pcs = [(tmp_path / t / "lib/pkgconfig/bjxa.pc").read_text().replace(
        str(tmp_path / t), "<prefix>") for t in "tj"]
    assert pcs[0] == pcs[1]
    res = subprocess.run([str(tmp_path / "t" / "bin" / "bjxa"), "decode"],
                         input=STREAMS["stereo6"](), capture_output=True)
    assert res.returncode == 0
    assert res.stdout == run_cli(tcli.main, ["decode"],
                                 STREAMS["stereo6"]())[1]

    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    got, want = both(["abi", "--install", str(blocker)])
    assert got == want and got[0] == 1 and got[2] == "abi: Not a directory\n"


def test_abi_install_refused_without_native(cpu_platform, monkeypatch,
                                            tmp_path):
    from bjxa_tpu.native import abi as jabi

    monkeypatch.setenv("BJXA_NO_NATIVE", "1")
    monkeypatch.setattr(jabi, "_lib", None)
    monkeypatch.setattr(jabi, "_tried", False)
    got, want = both(["abi", "--install", str(tmp_path / "p")])
    assert got[0] == want[0] == 1 and got[1] == want[1] == b""
    assert got[2].startswith("abi: C ABI library unavailable")
    assert want[2].startswith("abi: C ABI library unavailable")
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("flag", ["--devices", "--coordinator",
                                  "--num-processes", "--process-id"])
def test_unported_corpus_flags_fail(cpu_platform, tmp_path, flag):
    code, out, err = run_cli(tcli.main, ["corpus", flag, "1", str(tmp_path),
                                         str(tmp_path / "out")])
    assert code == 1 and out == b""
    assert err.startswith(f"bjxa: {flag} is not yet ported\n")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("var", ["BJXA_DEVICES", "BJXA_COORDINATOR",
                                 "BJXA_NUM_PROCESSES", "BJXA_PROCESS_ID"])
def test_unported_corpus_env_fails(cpu_platform, monkeypatch, tmp_path, var):
    monkeypatch.setenv(var, "1")
    code, out, err = run_cli(tcli.main, ["corpus", str(tmp_path),
                                         str(tmp_path / "out")])
    assert code == 1 and out == b""
    assert err.startswith(f"bjxa: {var} is not yet ported\n")


@pytest.fixture
def corpus_dir(tmp_path):
    """A small mixed XA directory: bits x channels, an invalid-profile
    file, a truncated file and a non-XA file."""
    src = tmp_path / "src"
    src.mkdir()
    specs = [(4, 1, 30), (6, 2, 41), (8, 2, 17), (6, 1, 64), (6, 2, 35)]
    for i, (bits, ch, blocks) in enumerate(specs):
        (src / f"f{i}.xa").write_bytes(make_xa(bits, ch, blocks, seed=20 + i))
    (src / "bad.xa").write_bytes(make_xa(6, 2, 40, seed=30, bad_block=9))
    (src / "cut.xa").write_bytes(make_xa(8, 1, 50, seed=31)[:-30])
    (src / "junk.xa").write_bytes(b"nope")
    return src


def corpus_both(monkeypatch, tmp_path, args, src):
    """``corpus <args> src out`` through both CLIs; the JAX one on one
    device (the test harness gives it 8 virtual CPU devices otherwise).
    Returns both (code, stdout, stderr) and both output directories."""
    outs = (tmp_path / "t_out", tmp_path / "j_out")
    got = run_cli(tcli.main, ["corpus", *args, str(src), str(outs[0])])
    monkeypatch.setenv("BJXA_DEVICES", "1")
    try:
        want = run_cli(jcli.main, ["corpus", *args, str(src), str(outs[1])])
    finally:
        monkeypatch.delenv("BJXA_DEVICES")
    return got, want, outs


def _files(d, pattern):
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


@pytest.mark.parametrize("args", [[], ["--batch-files", "2", "--depth", "1"]],
                         ids=["default", "small_batches"])
def test_corpus_decode_matches(cpu_platform, monkeypatch, tmp_path,
                               corpus_dir, args):
    got, want, (t_out, j_out) = corpus_both(monkeypatch, tmp_path, args,
                                            corpus_dir)
    assert got == want
    code, out, err = got
    assert code == 1 and out.startswith(b"converted 5 skipped 0 failed 3 ")
    assert err.count("corpus: ") == 3
    assert _files(t_out, "*.wav") == _files(j_out, "*.wav")
    assert len(_files(t_out, "*.wav")) == 5
    # a rerun skips what converted and retries the failures
    again = run_cli(tcli.main, ["corpus", *args, str(corpus_dir), str(t_out)])
    assert again[0] == 1 and again[1].startswith(
        b"converted 0 skipped 5 failed 3 "
    )


@pytest.mark.parametrize("args", [["--encode"],
                                  ["--encode", "--bits", "4", "--truncate"],
                                  ["--encode", "--bits", "8"]],
                         ids=["search6", "truncate4", "search8"])
def test_corpus_encode_matches(cpu_platform, monkeypatch, tmp_path, args):
    src = tmp_path / "wav"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i, (ch, frames) in enumerate([(1, 500), (2, 321), (2, 40)]):
        pcm = rng.integers(-20000, 20000, size=(frames, ch)).astype("<i2")
        (src / f"w{i}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, ch) + pcm.tobytes()
        )
    (src / "junk.wav").write_bytes(b"RIFF")
    got, want, (t_out, j_out) = corpus_both(monkeypatch, tmp_path, args, src)
    assert got == want
    assert got[0] == 1 and got[1].startswith(b"converted 3 skipped 0 failed 1")
    assert _files(t_out, "*.xa") == _files(j_out, "*.xa")
    assert len(_files(t_out, "*.xa")) == 3


@pytest.mark.parametrize("args", [
    ["--batch-files", "0", "a", "b"], ["--batch-files"], ["--depth", "x"],
    ["--manifest"], ["--bits", "5", "--encode"], ["--bits", "6", "a", "b"],
    ["--truncate", "a", "b"], ["--trace"], ["--frobnicate"], ["a"],
    ["a", "b", "c"], ["missing_dir", "out"],
], ids=lambda a: "_".join(a) or "none")
def test_corpus_option_failures_match(cpu_platform, monkeypatch, tmp_path,
                                      args):
    monkeypatch.chdir(tmp_path)
    got = run_cli(tcli.main, ["corpus", *args])
    monkeypatch.setenv("BJXA_DEVICES", "1")
    want = run_cli(jcli.main, ["corpus", *args])
    assert got[0] == want[0] == 1
    assert got[1] == want[1] == b""
    assert got[2].split("\n")[0] == want[2].split("\n")[0]


def test_corpus_trace_and_stats(cpu_platform, tmp_path, corpus_dir):
    from bjxa_tpu_torch.utils.profiler import TRACE_FILE

    trace = tmp_path / "trace"
    code, out, _err = run_cli(tcli.main, [
        "corpus", "--stats", "--trace", str(trace), str(corpus_dir),
        str(tmp_path / "out"),
    ])
    assert code == 1
    lines = out.decode().splitlines()
    assert lines[0].startswith("converted 5 skipped 0 failed 3 samples ")
    assert lines[1].startswith("stats files_per_s ")
    assert lines[1].split()[1::2] == ["files_per_s", "msamples_per_s",
                                      "mb_in_per_s", "mb_out_per_s",
                                      "elapsed_s"]
    assert (trace / TRACE_FILE).stat().st_size > 0


def test_no_cuda_refuses_to_run(monkeypatch):
    """Without a card and without BJXA_PLATFORM=cpu the port exits 1 and
    says why: it never decodes on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    code, out, err = run_cli(tcli.main, ["decode", "-", "-"],
                             make_xa(6, 1, 4, seed=1))
    assert code == 1 and out == b""
    assert err == ("bjxa: CUDA is not available; set BJXA_PLATFORM=cpu to"
                   " decode on the CPU\n")
    monkeypatch.setenv("BJXA_PLATFORM", "tpu")  # anything but cpu: the card
    code, _out, err = run_cli(tcli.main, ["decode", "-", "-"])
    assert code == 1 and err.startswith("bjxa: CUDA is not available")


def test_corpus_no_cuda_refuses_to_run(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    code, out, err = run_cli(tcli.main, ["corpus", str(tmp_path),
                                         str(tmp_path / "out")])
    assert code == 1 and out == b""
    assert err == ("bjxa: CUDA is not available; set BJXA_PLATFORM=cpu to"
                   " convert on the CPU\n")
    assert not (tmp_path / "out").exists()


def test_module_entry_point_loads_no_jax(tmp_path):
    """``python -m bjxa_tpu_torch decode`` runs without JAX in the
    process, and ``import bjxa_tpu_torch`` pulls in no JAX module."""
    src = tmp_path / "in.xa"
    src.write_bytes(make_xa(6, 2, 70, seed=10))
    env = dict(os.environ, BJXA_PLATFORM="cpu", PYTHONPATH=str(REPO))
    probe = (
        "import sys, runpy\n"
        "import bjxa_tpu_torch\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'jax']\n"
        "sys.argv = ['bjxa_tpu_torch', 'decode', sys.argv[1], sys.argv[2]]\n"
        "try:\n"
        "    runpy.run_module('bjxa_tpu_torch', run_name='__main__')\n"
        "finally:\n"
        "    assert not [m for m in sys.modules"
        " if m.split('.')[0] == 'jax'], 'jax imported'\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", probe, str(src), str(tmp_path / "o.wav")],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stderr
    assert res.stderr == ""
    from bjxa_tpu import xa_to_wav

    assert (tmp_path / "o.wav").read_bytes() == xa_to_wav(src.read_bytes())
