"""Segmented bounded-memory decode: throughput and peak RSS on a big file.

Port of ``benchmarks/bench_segmented.py``.  Generates a large synthetic XA
file on disk, decodes it through the CLI's segmented path
(``_decode_segmented`` via :func:`bjxa_tpu_torch.api.decode_xa_stream`), and
prints the end-to-end rate beside the process's peak RSS: the evidence for
"device-rate decode at O(segment) memory".

    python -m bjxa_tpu_torch.benchmarks.segmented

Env: ``BENCH_BLOCKS`` (default 2,097,152: ~105 MB of XA and 268 MB of PCM at
6-bit stereo), ``BENCH_SEGMENT`` (65,536), ``BENCH_REPS`` (3).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import tempfile
import time

import numpy as np

from bjxa_tpu_torch.benchmarks._common import (
    PeakRss,
    bench_device,
    emit,
    env_int,
)
from bjxa_tpu_torch.format import XAFormat, dump_xa_header


def write_big_xa(path: pathlib.Path, nblocks: int, seed: int, bits: int = 6,
                 channels: int = 2) -> XAFormat:
    """A seeded XA file of ``nblocks`` effective blocks (random payload,
    valid profiles), written 65,536 blocks at a time."""
    size = bits * 4 + 1
    rng = np.random.default_rng(seed)
    fmt = XAFormat(
        data_len=nblocks * size * channels, samples=nblocks * 32,
        samples_rate=44100, bits=bits, channels=channels,
        initial_state=((0, 0), (0, 0)),
    )
    with open(path, "wb") as f:
        f.write(dump_xa_header(fmt))
        step = 1 << 16
        for start in range(0, nblocks, step):
            nb = min(step, nblocks - start)
            body = rng.integers(0, 256, size=(nb, channels, size),
                                dtype=np.uint8)
            body[:, :, 0] = (
                rng.integers(0, 5, size=(nb, channels)) << 4
                | rng.integers(0, 13, size=(nb, channels))
            ).astype(np.uint8)
            f.write(body.tobytes())
    return fmt


def main() -> dict:
    from bjxa_tpu_torch import cli

    device = bench_device()  # the CLI resolves the same device itself
    nblocks = env_int("BENCH_BLOCKS", 2 * 1024 * 1024)
    segment = env_int("BENCH_SEGMENT", 65536)
    reps = env_int("BENCH_REPS", 3)
    work = pathlib.Path(tempfile.mkdtemp(prefix="bjxa_bench_seg_"))
    try:
        src, dst = work / "big.xa", work / "big.wav"
        t0 = time.perf_counter()
        fmt = write_big_xa(src, nblocks, seed=5)
        gen_s = time.perf_counter() - t0
        times = []
        with PeakRss() as rss:
            before_mb = rss.peak_mb
            for _ in range(reps):
                t0 = time.perf_counter()
                rc = cli.main(["bjxa", "decode", "--segment-blocks",
                               str(segment), str(src), str(dst)])
                times.append(time.perf_counter() - t0)
                if rc != 0:
                    raise RuntimeError(f"segmented decode exited {rc}")
        out_bytes = os.path.getsize(dst)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    samples = fmt.samples * fmt.channels
    dt = sorted(times)[len(times) // 2]
    return emit({
        "metric": "segmented_decode_rate",
        "value": round(samples / dt / 1e6, 1),
        "unit": "Msamples/s",
        "xa_mb": round(fmt.data_len / 1e6, 1),
        "pcm_mb": round(out_bytes / 1e6, 1),
        "seconds_median": round(dt, 3),
        "runs_s": [round(t, 3) for t in times],
        "pcm_mb_per_s": round(out_bytes / dt / 1e6, 1),
        "segment_blocks": segment,
        "gen_s": round(gen_s, 1),
        "peak_rss_mb": round(rss.peak_mb, 1),
        "rss_growth_mb": round(rss.peak_mb - before_mb, 1),
    }, device)


if __name__ == "__main__":
    main()
