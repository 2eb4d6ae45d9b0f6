"""End-to-end corpus decode benchmark: XA files on disk -> WAV files on disk.

Port of ``benchmarks/bench_corpus.py``.  Measures the whole engine -- header
parse, host staging, device transfer, the words kernel, WAV serialization,
manifest bookkeeping -- in files/s and Msamples/s, comparable to the
reference CLI's ~77 files/s (stereo 8-bit, 1.32 Msamples a file, one Xeon
core; BASELINE.md), with the median run's own stage spans
(``Counters.stage_ms``) in place of the original's link probes.

    python -m bjxa_tpu_torch.benchmarks.corpus

Env: ``BENCH_FILES`` (64), ``BENCH_BLOCKS`` (20,672, the fixture size),
``BENCH_BITS`` (8), ``BENCH_BATCH_FILES`` (16), ``BENCH_REPS`` (5).
"""

from __future__ import annotations

from bjxa_tpu_torch.bench import time_corpus
from bjxa_tpu_torch.benchmarks._common import bench_device, emit, env_int


def main() -> dict:
    device = bench_device()
    return emit(time_corpus(
        env_int("BENCH_FILES", 64), env_int("BENCH_BLOCKS", 20672),
        env_int("BENCH_BITS", 8), env_int("BENCH_BATCH_FILES", 16),
        env_int("BENCH_REPS", 5), device, seed=7,
    ), device)


if __name__ == "__main__":
    main()
