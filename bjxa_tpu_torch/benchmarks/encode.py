"""Encoder throughput benchmark (profile-search encode, samples/s).

Port of ``benchmarks/bench_encode.py``: the search kernel alone on
full-scale noise, as :func:`bjxa_tpu_torch.bench.time_encode_search` times
it for the headline script, under this script's own variables.

    python -m bjxa_tpu_torch.benchmarks.encode

Env: ``BENCH_BITS`` (6), ``BENCH_BLOCKS`` (32), ``BENCH_LANES`` (4096),
``BENCH_REPS``.
"""

from __future__ import annotations

from bjxa_tpu_torch.bench import time_encode_search
from bjxa_tpu_torch.benchmarks._common import bench_device, emit, env_int


def main() -> dict:
    device = bench_device()
    return emit(time_encode_search(
        env_int("BENCH_BITS", 6), env_int("BENCH_BLOCKS", 32),
        env_int("BENCH_LANES", 4096), env_int("BENCH_REPS", 10), device,
        seed=0,
    ), device)


if __name__ == "__main__":
    main()
