"""Multi-process corpus scaling: files/s at 1 -> 2 -> 4 processes.

Port of ``benchmarks/bench_multihost.py``.  Each "host" is a separate OS
process that joins one job through :mod:`bjxa_tpu_torch.parallel.
distributed` (gloo on ``127.0.0.1``) and runs the real CLI corpus action on
its round-robin share of the files, on the device the CLI picks (the CUDA
card, or the CPU under ``BJXA_PLATFORM=cpu``).  The metric is the job's
files/s from process 0's ``--stats`` line, whose elapsed time is the
slowest process's (:func:`~bjxa_tpu_torch.parallel.distributed.
allreduce_counters`).  On a one-card host every process shares the card
and the host's cores, so the scaling measured there is the overhead of the
processes and the group, not what a host per process would give.

    python -m bjxa_tpu_torch.benchmarks.multihost

Env: ``BENCH_FILES`` (32 stereo 8-bit files), ``BENCH_SAMPLES`` (66,150
frames a file), ``BENCH_BATCH_FILES`` (8), ``BENCH_PROCS`` (``1,2,4``);
each process has TIMEOUT_S (600 s).  Each process count runs once: the
JAX original warms a compile cache first, and the port compiles nothing
per process (its kernels are built once, on disk, by the first process
that needs them).  Prints one JSON line.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from bjxa_tpu_torch.benchmarks._common import bench_device, emit, env_int

REPO = pathlib.Path(__file__).resolve().parents[2]
#: Seconds any one process of a job may take.
TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_corpus(src: pathlib.Path, n_files: int, samples: int) -> None:
    """Seeded stereo 8-bit XA files (truncation encode on the host: the
    set-up, not the measurement)."""
    from bjxa_tpu_torch.api import encode_pcm

    rng = np.random.default_rng(0)
    src.mkdir(parents=True, exist_ok=True)
    base = rng.integers(-25000, 25000, size=(samples, 2)).astype(np.int16)
    for i in range(n_files):
        pcm = np.roll(base, i * 97, axis=0)
        (src / f"f{i:04d}.xa").write_bytes(
            encode_pcm(pcm, 44100, 8, search=False, device="cpu")
        )


def run_job(src, out, n_processes: int, batch_files: int) -> dict:
    """One corpus job over ``n_processes`` processes: process 0's stats and
    summary line and the job's wall clock.  A process that fails raises,
    and none outlives :data:`TIMEOUT_S`."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "bjxa_tpu_torch", "corpus",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_processes), "--process-id", str(i),
             "--batch-files", str(batch_files), "--stats", str(src),
             str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for i in range(n_processes)
    ]
    stats, summary = {}, None
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{stderr}\n{stdout}")
            for line in stdout.splitlines():
                if line.startswith("stats "):
                    parts = line.split()[1:]
                    stats = {parts[j]: float(parts[j + 1])
                             for j in range(0, len(parts), 2)}
                elif line.startswith("converted "):
                    summary = line
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(stats, wall_s=time.perf_counter() - t0, summary=summary)


def main() -> dict:
    device = bench_device()  # the card the workers find, or the CPU
    n_files = env_int("BENCH_FILES", 32)
    samples = env_int("BENCH_SAMPLES", 66150)
    batch_files = env_int("BENCH_BATCH_FILES", 8)
    counts = [int(n) for n in
              os.environ.get("BENCH_PROCS", "1,2,4").split(",")]

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bjxa-mh-"))
    try:
        src = tmp / "src"
        make_corpus(src, n_files, samples)
        results = {}
        for n in counts:
            out = tmp / f"out{n}"
            results[n] = run_job(src, out, n, batch_files)
            shutil.rmtree(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    base = results[counts[0]]
    summaries = {r["summary"] for r in results.values()}
    if len(summaries) != 1:
        raise AssertionError(f"multihost: the jobs' totals differ: {summaries}")
    return emit({
        "metric": "multihost_corpus_files_per_s",
        "files": n_files, "samples": samples, "batch_files": batch_files,
        "summary": summaries.pop(),
        "processes": {
            str(n): {
                "files_per_s": r["files_per_s"],
                "elapsed_s": r["elapsed_s"],
                "wall_s": r["wall_s"],
                "vs_first": r["files_per_s"] / base["files_per_s"],
            }
            for n, r in results.items()
        },
    }, device)


if __name__ == "__main__":
    main()
