"""Multi-process corpus jobs of the PyTorch port, against :mod:`bjxa_tpu`.

``initialize``'s validation against the JAX package's (same exceptions,
same messages), the single-process identities, a one-process group joined
and left in this process, and two real OS processes joining one job
through ``python -m bjxa_tpu_torch corpus --coordinator 127.0.0.1:<port>
--num-processes 2 --process-id i`` (gloo on the loopback): disjoint file
shares whose union equals a one-process run and the JAX package's bytes,
and process 0's summary line equal to the one-process line.  Every spawned
process has a wall clock of 120 s and is killed past it.  The mirror of
``tests/test_distributed.py``.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from bjxa_tpu.api import encode_pcm as jencode_pcm
from bjxa_tpu.api import xa_to_wav as jxa_to_wav
from bjxa_tpu.parallel import distributed as jdist
from bjxa_tpu_torch import cli as tcli
from bjxa_tpu_torch import dump_pcm, dump_riff_header
from bjxa_tpu_torch.parallel import distributed
from bjxa_tpu_torch.utils.profiler import Counters
from test_torch_cli import fresh_jax_initialize, run_cli

REPO = pathlib.Path(__file__).resolve().parent.parent
WALL_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("BJXA_COORDINATOR", "BJXA_NUM_PROCESSES", "BJXA_PROCESS_ID",
                "BJXA_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")


INIT_CASES = {
    "count_without_id": ("127.0.0.1:1", 2, None, ()),
    "id_without_count": ("127.0.0.1:1", None, 0, ()),
    "id_out_of_range": ("127.0.0.1:1", 2, 5, ()),
    "zero_processes": ("127.0.0.1:1", 0, 0, ()),
    "no_coordinator": (None, 2, 0, ()),
    "no_count": ("127.0.0.1:1", None, None, ()),
    "env_count_only": (None, None, None, (("BJXA_NUM_PROCESSES", "2"),)),
    "env_no_coordinator": (None, None, None, (("BJXA_NUM_PROCESSES", "3"),
                                              ("BJXA_PROCESS_ID", "1"))),
    "nothing": (None, None, None, ()),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_initialize_validation_matches(clean_env, monkeypatch, case):
    """The port's answer to each request is the JAX package's, asked in a
    fresh process: the same ``ValueError`` message, or False when nothing
    was asked."""
    want = dict(zip(INIT_CASES,
                    fresh_jax_initialize(tuple(INIT_CASES.values()))))[case]
    coordinator, count, pid, env = INIT_CASES[case]
    for k, v in env:
        monkeypatch.setenv(k, v)
    if want is False:
        assert distributed.initialize(coordinator, count, pid) is False
    else:
        with pytest.raises(ValueError) as got:
            distributed.initialize(coordinator, count, pid)
        assert str(got.value) == want
    assert distributed.process_info() == (0, 1)


def test_single_process_identities(clean_env):
    assert distributed.initialize(None, None, None) is False
    assert distributed.process_info() == (0, 1) == jdist.process_info()
    assert distributed.allreduce_sum([3, 4]) == [3, 4]
    c = Counters(files=2, samples=100)
    assert distributed.allreduce_counters(c) is c
    distributed.shutdown()  # nothing joined: a no-op


def test_one_process_group_joins_and_leaves(clean_env):
    """A real gloo group of one process: joined once (a second call sees
    it), its rank and size read back, its reductions the identity, and
    left by ``shutdown``."""
    addr = f"127.0.0.1:{_free_port()}"
    try:
        assert distributed.initialize(addr, 1, 0) is True
        assert distributed.process_info() == (0, 1)
        assert distributed.initialize(addr, 1, 0) is True
        assert distributed.process_info() == (0, 1)
        assert distributed.allreduce_sum([2**40, 5]) == [2**40, 5]
    finally:
        distributed.shutdown()
    assert distributed.process_info() == (0, 1)


def _spawn(argvs, envs):
    """Start one ``python -m bjxa_tpu_torch`` per argv (with its own
    environment), wait at most ``WALL_S`` for all of them (killing every
    one past it), and return ``[(code, stdout, stderr)]`` in order."""
    procs = [
        subprocess.Popen([sys.executable, "-m", "bjxa_tpu_torch", *argv],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env, cwd=REPO, text=True)
        for argv, env in zip(argvs, envs)
    ]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WALL_S)
            out.append((p.returncode, stdout, _without_c10d(stderr)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _without_c10d(stderr: str) -> str:
    """``stderr`` less torch.distributed's own log lines (a hostname the
    loopback socket cannot resolve is logged as a warning)."""
    return "".join(line for line in stderr.splitlines(keepends=True)
                   if "[c10d]" not in line)


def _child_env(**extra):
    env = dict(os.environ, BJXA_PLATFORM="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    for var in ("BJXA_COORDINATOR", "BJXA_NUM_PROCESSES", "BJXA_PROCESS_ID",
                "BJXA_DEVICES"):
        if var not in extra:
            env.pop(var, None)
    return env


def _outputs(d, pattern):
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


def _shares(d):
    """The input file names each process's manifest records."""
    return [
        {pathlib.Path(json.loads(line)["key"]).name
         for line in (d / f".bjxa-{kind}manifest-{rank}.jsonl").read_text()
         .splitlines() if line.strip()}
        for rank in (0, 1)
        for kind in ("encode-", "")
        if (d / f".bjxa-{kind}manifest-{rank}.jsonl").exists()
    ]


def _two_process_job(tmp_path, src, extra_args, by_env):
    """Run ``corpus`` over ``src`` in two processes (flags, or the
    ``BJXA_*`` variables when ``by_env``) and in one process (in this
    one); returns both results and both output directories."""
    port = _free_port()
    two, one = tmp_path / "two", tmp_path / "one"
    argvs, envs = [], []
    for i in range(2):
        if by_env:
            argvs.append(["corpus", *extra_args, str(src), str(two)])
            envs.append(_child_env(BJXA_COORDINATOR=f"127.0.0.1:{port}",
                                   BJXA_NUM_PROCESSES="2",
                                   BJXA_PROCESS_ID=str(i)))
        else:
            argvs.append(["corpus", "--coordinator", f"127.0.0.1:{port}",
                          "--num-processes", "2", "--process-id", str(i),
                          *extra_args, str(src), str(two)])
            envs.append(_child_env())
    procs_out = _spawn(argvs, envs)
    single = run_cli(tcli.main, ["corpus", *extra_args, str(src), str(one)])
    return procs_out, single, two, one


def test_two_process_corpus_decode(clean_env, tmp_path):
    """Two processes by the flags: disjoint shares that cover the corpus,
    the one-process bytes and the JAX package's, process 0's summary equal
    to the one-process summary (a junk file counted once, failed in
    whichever process took it), nothing printed by process 1."""
    rng = np.random.default_rng(7)
    src = tmp_path / "src"
    src.mkdir()
    expect = {}
    for i, (bits, ch, samples) in enumerate(
        [(4, 1, 120), (6, 2, 321), (8, 2, 96), (6, 1, 500), (8, 1, 257)]
    ):
        sig = rng.integers(-25000, 25000, size=(samples, ch)).astype(np.int16)
        xa = jencode_pcm(sig, 44100, bits, search=False)
        (src / f"f{i}.xa").write_bytes(xa)
        expect[f"f{i}.wav"] = jxa_to_wav(xa)
    (src / "junk.xa").write_bytes(b"nope")
    procs, single, two, one = _two_process_job(tmp_path, src, [], False)
    (c0, out0, err0), (c1, out1, err1) = procs
    assert single[0] == 1 and single[1].startswith(
        b"converted 5 skipped 0 failed 1 samples ")
    assert out0.encode() == single[1] and out1 == ""
    assert sorted([c0, c1]) == [0, 1]  # the junk file failed in one
    assert sorted([err0, err1]) == ["", single[2]]
    assert _outputs(two, "*.wav") == _outputs(one, "*.wav") == expect
    keys0, keys1 = _shares(two)
    assert keys0 and keys1 and not keys0 & keys1
    assert keys0 | keys1 == {f"f{i}.xa" for i in range(5)}


def test_two_process_corpus_encode(clean_env, tmp_path):
    """Two processes by the ``BJXA_*`` variables, search-encoding: the
    one-process bytes and the JAX package's, one summary line."""
    rng = np.random.default_rng(8)
    src = tmp_path / "wav"
    src.mkdir()
    expect = {}
    for i, (ch, samples) in enumerate([(1, 200), (2, 333), (1, 64)]):
        pcm = rng.integers(-30000, 30000, size=(samples, ch)).astype(np.int16)
        (src / f"w{i}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, ch) + dump_pcm(pcm))
        expect[f"w{i}.xa"] = jencode_pcm(pcm, 44100, 6, search=True)
    procs, single, two, one = _two_process_job(tmp_path, src, ["--encode"],
                                               True)
    (c0, out0, err0), (c1, out1, err1) = procs
    assert (c0, c1, err0, err1) == (0, 0, "", "")
    assert single == (0, out0.encode(), "") and out1 == ""
    assert out0.startswith("converted 3 skipped 0 failed 0 samples ")
    assert _outputs(two, "*.xa") == _outputs(one, "*.xa") == expect
    keys0, keys1 = _shares(two)
    assert keys0 and keys1 and not keys0 & keys1
    assert keys0 | keys1 == {f"w{i}.wav" for i in range(3)}
