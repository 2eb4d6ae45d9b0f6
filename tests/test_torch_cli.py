"""The PyTorch port's CLI against :mod:`bjxa_tpu.cli`, both on the CPU
(``BJXA_PLATFORM=cpu``): same exit code, stdout bytes and stderr for the
decode surface, plus the port's own guarantees (no JAX import, no silent
CPU run without ``BJXA_PLATFORM=cpu``).

Streams stay under 2048 blocks, so the JAX CLI takes its single-device
path on the test harness's virtual CPU mesh.
"""

import functools
import io
import json
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
    """Same exit code and error label; the usage text that follows lists
    the JAX package's actions and options, with this port's device
    notes."""
    (tc, tout, terr), (jc, jout, jerr) = both(args)
    assert tc == jc
    assert terr.split("\n")[0] == jerr.split("\n")[0]
    assert tout[:6] == jout[:6]
    usage = tout.decode() if args == ["help"] else terr
    assert ("decode [--streaming] [--devices <n>] [--segment-blocks <n>]\n"
            "         [<xa file> [<wav file>]]" in usage)
    assert ("encode [--bits <4|6|8>] [--truncate] [--devices <n>]\n"
            "         [--segment-blocks <n>] [<wav file> [<xa file>]]"
            in usage)
    assert ("corpus [--batch-files <n>] [--depth <k>] [--manifest <path>]\n"
            "         [--devices <n>]" in usage)
    assert "  abi --install <prefix>\n" in usage
    assert ("Multi-host: --coordinator <host:port> --num-processes\n"
            "    <n> --process-id <i> (or BJXA_COORDINATOR /" in usage)


@pytest.fixture
def eight_cpus(monkeypatch):
    """Eight CPU entries as the local devices, as the JAX package's eight
    virtual CPU devices of the test harness."""
    monkeypatch.setattr(tcli, "_local_devices",
                        lambda: [torch.device("cpu")] * 8)


@pytest.mark.parametrize("flag", ["--streaming", "--devices",
                                  "--segment-blocks"])
def test_unported_decode_flags_fail(cpu_platform, eight_cpus, monkeypatch,
                                   tmp_path, flag):
    """Every decode option answers as bjxa_tpu's CLI does.  ``--streaming``
    and ``--segment-blocks``: a missing input, and the bytes and stderr of
    a valid, a cut and an invalid-profile stream, equal to the whole-file
    decode's.  ``--devices`` (eight CPU entries against the JAX package's
    eight devices): 1 and 8 decode the same bytes, 0 is refused with the
    usage, 9 and a bad ``BJXA_DEVICES`` exit 1 with one line."""
    if flag == "--streaming":
        got, want = both(["decode", flag, "2", str(tmp_path / "x.xa")])
        assert got == want and got[0] == 1 and got[2].startswith("Error: ")
        for name, data in STREAMS.items():
            got, want = both(["decode", flag, "-", "-"], data())
            assert got == want, name
            assert got == run_cli(tcli.main, ["decode"], data()), name
        return
    if flag == "--devices":
        for n in ("1", "8"):
            for name in ("stereo6", "invalid_profile", "truncated"):
                got, want = both(["decode", flag, n, "-", "-"],
                                 STREAMS[name]())
                assert got == want, (n, name)
                assert got == run_cli(tcli.main, ["decode"],
                                      STREAMS[name]())
        got, want = both(["decode", flag, "0", "x.xa"])
        assert got[0] == want[0] == 1 and got[1] == want[1] == b""
        assert got[2].split("\n")[0] == want[2].split("\n")[0] == (
            "bjxa: Invalid --devices")
        got, want = both(["decode", flag, "9", "-", "-"], STREAMS["stereo6"]())
        assert got == want == (
            1, b"", "bjxa: --devices 9 out of range (1..8 available)\n")
        monkeypatch.setenv("BJXA_DEVICES", "x")
        got, want = both(["decode", "-", "-"], STREAMS["stereo6"]())
        assert got == want == (1, b"", "bjxa: Invalid BJXA_DEVICES 'x'\n")
        return
    monkeypatch.setenv("BJXA_DEVICES", "1")  # one device in both CLIs
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


FRESH_JAX_INIT = """
import json, os, sys
from bjxa_tpu.parallel import distributed
out = []
for coordinator, count, pid, env in json.loads(sys.argv[1]):
    for var in ("BJXA_COORDINATOR", "BJXA_NUM_PROCESSES", "BJXA_PROCESS_ID"):
        os.environ.pop(var, None)
    os.environ.update(env)
    try:
        out.append(distributed.initialize(coordinator, count, pid))
    except ValueError as e:
        out.append(str(e))
print(json.dumps(out))
"""


@functools.cache
def fresh_jax_initialize(cases: tuple) -> list:
    """What :func:`bjxa_tpu.parallel.distributed.initialize` answers to each
    ``(coordinator, count, pid, env)`` case, its ``ValueError`` message or
    its result, in ONE fresh JAX process: past its own checks it calls
    ``jax.distributed.initialize``, which refuses every call once a JAX
    backend is up, as it is in a test process.  No case may succeed: a
    successful one would wait for its peers."""
    res = subprocess.run(
        [sys.executable, "-c", FRESH_JAX_INIT,
         json.dumps([list(c[:3]) + [dict(c[3])] for c in cases])],
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.splitlines()[-1])


#: Corpus options of both CLIs and the cases each answers: its arguments
#: (the input and output directories follow them, except where they end in
#: an option that wants a value), the first stderr line of both tools
#: (None: a run that converts), and where the JAX package's line comes from
#: ``jax.distributed.initialize``, the arguments it gets (its CLI is then
#: asked in a fresh process, :func:`fresh_jax_initialize`).
CORPUS_FLAG_CASES = {
    "--devices": [(["--devices", "1"], None, None),
                  (["--devices", "0"], "bjxa: Invalid --devices", None),
                  (["--devices", "9"],
                   "bjxa: --devices 9 out of range (1..8 available)", None)],
    "--coordinator": [
        (["--coordinator"], "bjxa: Missing coordinator address", None),
        (["--coordinator", "127.0.0.1:1"],
         "bjxa: Number of processes must be defined.",
         ("127.0.0.1:1", None, None, ()))],
    "--num-processes": [
        (["--num-processes", "0"], "bjxa: Invalid --num-processes", None),
        (["--num-processes", "2"],
         "bjxa: --process-id and --num-processes must be given together",
         None),
        (["--num-processes", "1", "--process-id", "0"],
         "bjxa: coordinator_address should be defined.", (None, 1, 0, ()))],
    "--process-id": [
        (["--process-id", "x"], "bjxa: Invalid --process-id", None),
        (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
          "--process-id", "3"], "bjxa: process id out of range", None)],
}


def _corpus_src(tmp_path):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    for i, (bits, ch, blocks) in enumerate([(4, 1, 30), (6, 2, 41)]):
        (src / f"f{i}.xa").write_bytes(make_xa(bits, ch, blocks, seed=40 + i))
    return src


@pytest.mark.parametrize("flag", ["--devices", "--coordinator",
                                  "--num-processes", "--process-id"])
def test_unported_corpus_flags_fail(cpu_platform, eight_cpus, tmp_path,
                                    flag):
    """Every corpus option of the device mesh and the multi-process job
    answers as bjxa_tpu's CLI does (eight CPU entries against its eight
    devices): the same exit code, stdout and error line, and no output
    directory, for each refusal; ``--devices 1`` converts the same
    bytes."""
    src = _corpus_src(tmp_path)
    fresh = fresh_jax_initialize(tuple(
        c[2] for c in CORPUS_FLAG_CASES[flag] if c[2] is not None))
    for k, (args, line, init) in enumerate(CORPUS_FLAG_CASES[flag]):
        outs = (tmp_path / f"t{k}", tmp_path / f"j{k}")
        dirs = [[], []] if args == [flag] else [[str(src), str(o)]
                                                for o in outs]
        got = run_cli(tcli.main, ["corpus", *args, *dirs[0]])
        if init is not None:
            assert got[2].split("\n")[0] == f"bjxa: {fresh.pop(0)}"
            want = (1, b"", got[2])
        else:
            want = run_cli(jcli.main, ["corpus", *args, *dirs[1]])
        assert got[0] == want[0] and got[1] == want[1], args
        assert got[2].split("\n")[0] == want[2].split("\n")[0], args
        if line is None:
            assert got == want and got[0] == 0 and got[1].startswith(
                b"converted 2 skipped 0 failed 0 samples ")
            assert _files(outs[0], "*.wav") == _files(outs[1], "*.wav")
            continue
        assert got[0] == 1 and got[1] == b"" and got[2].startswith(
            line + "\n"), args
        assert not outs[0].exists()


@pytest.mark.parametrize("var", ["BJXA_DEVICES", "BJXA_COORDINATOR",
                                 "BJXA_NUM_PROCESSES", "BJXA_PROCESS_ID"])
def test_unported_corpus_env_fails(cpu_platform, eight_cpus, monkeypatch,
                                   tmp_path, var):
    """Each variable of the mesh and the multi-process job, read as
    bjxa_tpu's CLI reads it: the same refusal, exit code and stdout
    (``BJXA_COORDINATOR`` alone reaches ``jax.distributed.initialize``,
    asked in a fresh process)."""
    value, line = {
        "BJXA_DEVICES": ("9", "bjxa: BJXA_DEVICES 9 out of range"
                              " (1..8 available)"),
        "BJXA_COORDINATOR": ("127.0.0.1:1",
                             "bjxa: Number of processes must be defined."),
        "BJXA_NUM_PROCESSES": ("2", "bjxa: --process-id and"
                                    " --num-processes must be given"
                                    " together"),
        "BJXA_PROCESS_ID": ("1", "bjxa: --process-id and --num-processes"
                                 " must be given together"),
    }[var]
    monkeypatch.setenv(var, value)
    src = _corpus_src(tmp_path)
    got = run_cli(tcli.main, ["corpus", str(src), str(tmp_path / "t")])
    if var == "BJXA_COORDINATOR":
        (msg,) = fresh_jax_initialize(((None, None, None, ((var, value),)),))
        want = (1, b"", f"bjxa: {msg}\n")
    else:
        want = run_cli(jcli.main, ["corpus", str(src), str(tmp_path / "j")])
    assert got[0] == want[0] == 1 and got[1] == want[1] == b""
    assert got[2].split("\n")[0] == want[2].split("\n")[0] == line
    assert not (tmp_path / "t").exists()


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
