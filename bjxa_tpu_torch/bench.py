"""Headline benchmark of the PyTorch/CUDA port: XA decode throughput on one
card, plus the encode-kernel and corpus-engine metrics.

Port of the root ``bench.py``.  Prints one JSON line per metric, the decode
headline LAST, each with the card's name and power limit under ``"device"``:

  {"metric": "encode_search_throughput", "value": <Msamples/s>, ...}
  {"metric": "corpus_decode_files_per_s", "value": <files/s>, ...}
  {"metric": "decode_throughput", "value": <Msamples/s>,
   "unit": "Msamples/s", "vs_baseline": <ratio>}

    python -m bjxa_tpu_torch.bench

Baselines (BASELINE.md, CPU figures, one Xeon core): the reference C
library decodes ~100 Msamples/s and its CLI converts ~77 files/s disk to
disk; the reference's truncation-only encoder measures ~250 Msamples/s.
The search encoder's ``vs_baseline`` is against that number while doing the
80-profile exhaustive search the reference lacks.  ``BENCH_SKIP_EXTRAS=1``
prints the decode headline alone.

Methodology: the headline workload is a large batch of 8-bit stereo streams
(``BENCH_FILES`` x ``BENCH_BLOCKS``, ``BENCH_BITS``) decoded by
:func:`~bjxa_tpu_torch.ops.decode.decode_batch_words` from the packed-words
layout the corpus engine stages, producing filtered PCM and carried state.
Data is generated on the device.  Device work is timed by CUDA events over
windows of many launches after a warm-up, median of ``BENCH_REPS`` windows;
the corpus metric is a host clock around a disk-to-disk run after a warm
pass.  The device is the CUDA card unless ``BJXA_PLATFORM=cpu``.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from bjxa_tpu_torch.benchmarks._common import (
    NoDeviceError,
    bench_device,
    emit,
    env_int,
    time_ms,
)
from bjxa_tpu_torch.format import XAFormat, dump_xa_header
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

DECODE_BASELINE_MSPS = 100.0  # reference C decoder, one Xeon core
ENCODE_BASELINE_MSPS = 250.0  # reference truncation encoder, one Xeon core
CORPUS_BASELINE_FILES_S = 77.0  # reference CLI, disk to disk, one Xeon core


def time_encode_search(bits: int, blocks: int, lanes: int, reps: int,
                       device: torch.device, seed: int) -> dict:
    """Search-encode throughput: all 80 candidate profiles evaluated per
    block with the real decode recurrence in the loop, on full-scale noise
    made on the device."""
    from bjxa_tpu_torch.ops.encode import encode_search

    g = torch.Generator(device=device).manual_seed(seed)
    pcm = torch.randint(-(2**15), 2**15, (blocks, BLOCK_SAMPLES, lanes),
                        generator=g, device=device).to(torch.int16)
    state = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
    ms = time_ms(lambda: encode_search(pcm, state, bits=bits), device,
                 reps=reps, inner=4)
    msps = blocks * BLOCK_SAMPLES * lanes / ms / 1e3
    return {
        "metric": "encode_search_throughput",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / ENCODE_BASELINE_MSPS, 2),
        "ms": round(ms, 6),
        "bits": bits, "blocks": blocks, "lanes": lanes,
    }


def bench_encode(device: torch.device) -> dict:
    return emit(time_encode_search(
        env_int("BENCH_ENC_BITS", 6), env_int("BENCH_ENC_BLOCKS", 32),
        env_int("BENCH_ENC_LANES", 4096), env_int("BENCH_REPS", 10),
        device, seed=3,
    ), device)


def write_corpus(xa_dir: pathlib.Path, n_files: int, nblocks: int, bits: int,
                 seed: int, channels: int = 2) -> None:
    """Synthetic fixture-sized stereo XA files: random payload, valid
    profiles."""
    size = bits * 4 + 1
    rng = np.random.default_rng(seed)
    hdr = dump_xa_header(XAFormat(
        data_len=nblocks * size * channels, samples=nblocks * BLOCK_SAMPLES,
        samples_rate=44100, bits=bits, channels=channels,
        initial_state=((0, 0), (0, 0)),
    ))
    for i in range(n_files):
        body = rng.integers(
            0, 256, nblocks * channels * size, dtype=np.uint8
        ).reshape(nblocks * channels, size)
        body[:, 0] = (body[:, 0] & 0x0F) | (
            rng.integers(0, 5, nblocks * channels).astype(np.uint8) << 4
        )
        with open(xa_dir / f"f{i:04d}.xa", "wb") as f:
            f.write(hdr)
            f.write(body.tobytes())


def time_corpus(n_files: int, nblocks: int, bits: int, batch_files: int,
                reps: int, device: torch.device, seed: int) -> dict:
    """Disk-to-disk corpus decode through the full engine (parse, staging,
    device, WAV write, manifest): the median of ``reps`` runs after an
    untimed warm pass, with that run's own stage spans."""
    from bjxa_tpu_torch.parallel.corpus import decode_corpus

    channels = 2
    work = pathlib.Path(tempfile.mkdtemp(prefix="bjxa_bench_"))
    try:
        xa_dir, wav_dir = work / "xa", work / "wav"
        xa_dir.mkdir()
        write_corpus(xa_dir, n_files, nblocks, bits, seed, channels)
        runs = []
        for rep in range(reps + 1):  # the first pass warms and is dropped
            t0 = time.perf_counter()
            res = decode_corpus(xa_dir, wav_dir, device=device,
                                batch_files=batch_files)
            dt = time.perf_counter() - t0
            if res.converted != n_files or res.failed:
                raise RuntimeError(f"corpus run converted {res.converted} of"
                                   f" {n_files}: {res.failed}")
            shutil.rmtree(wav_dir)
            if rep:
                runs.append((dt, res.counters))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    runs.sort(key=lambda r: r[0])
    dt, counters = runs[len(runs) // 2]
    samples = n_files * nblocks * BLOCK_SAMPLES * channels
    return {
        "metric": "corpus_decode_files_per_s",
        "value": round(n_files / dt, 2),
        "unit": "files/s",
        "msamples_per_s": round(samples / dt / 1e6, 1),
        "vs_baseline": round(n_files / dt / CORPUS_BASELINE_FILES_S, 3),
        "best_files_per_s": round(n_files / runs[0][0], 2),
        "runs_s": [round(r[0], 4) for r in runs],
        "stage_ms": {k: round(v, 3)
                     for k, v in sorted(counters.stage_ms.items())},
        "files": n_files, "blocks": nblocks, "bits": bits,
        "batch_files": batch_files,
    }


def bench_corpus(device: torch.device) -> dict:
    return emit(time_corpus(
        env_int("BENCH_CORPUS_FILES", 32), env_int("BENCH_CORPUS_BLOCKS", 20672),
        env_int("BENCH_CORPUS_BITS", 8), env_int("BENCH_CORPUS_BATCH", 16),
        1, device, seed=11,
    ), device)


def bench_decode(device: torch.device) -> dict:
    """The headline: batch words decode of ``BENCH_FILES`` stereo files x
    ``BENCH_BLOCKS`` blocks."""
    from bjxa_tpu_torch.benchmarks.roofline_bound import (
        words_inputs,
        words_traffic,
    )
    from bjxa_tpu_torch.ops.decode import decode_batch_words

    bits = env_int("BENCH_BITS", 8)
    lanes = env_int("BENCH_FILES", 16384) * 2
    blocks = env_int("BENCH_BLOCKS", 64)
    reps = env_int("BENCH_REPS", 10)
    prof, words, state = words_inputs(7, blocks, lanes, bits, device)
    ms = time_ms(lambda: decode_batch_words(prof, words, state, bits=bits),
                 device, reps=reps)
    msps = lanes * blocks * BLOCK_SAMPLES / ms / 1e3
    return emit({
        "metric": "decode_throughput",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / DECODE_BASELINE_MSPS, 2),
        "ms": round(ms, 6),
        "gb_per_s": round(words_traffic(blocks, lanes, bits) / ms / 1e6, 1),
        "bits": bits, "lanes": lanes, "blocks": blocks,
    }, device)


def main() -> int:
    try:
        device = bench_device()
    except NoDeviceError as e:
        sys.stderr.write(f"bench: {e}\n")
        return 1
    if not os.environ.get("BENCH_SKIP_EXTRAS"):
        bench_encode(device)
        bench_corpus(device)
    bench_decode(device)  # the headline stays the final line
    return 0


if __name__ == "__main__":
    sys.exit(main())
