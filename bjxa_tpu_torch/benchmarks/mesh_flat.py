"""The mesh path's corpus decode: the sharded words path against the
sharded lanes path, on a one-device mesh.

Port of ``benchmarks/bench_mesh_flat.py``.  The corpus engine's mesh branch
stages packed words and takes each shard's PCM back as one flat vector
(:func:`~bjxa_tpu_torch.parallel.sharded.decode_corpus_sharded_words`, the
words kernel); the lane-major branch stages raw bytes and takes 3-D PCM
back (:func:`~bjxa_tpu_torch.parallel.sharded.decode_corpus_sharded_lanes`,
the lanes kernel).  This script times both end to end -- host staging,
host->device copy, decode, device->host copy, host reassembly -- on a mesh
of the one device it runs on, at a typical corpus batch, checks that they
give the same PCM, and prints one JSON line.

    python -m bjxa_tpu_torch.benchmarks.mesh_flat

Env: ``BENCH_BLOCKS`` (20,672), ``BENCH_FILES`` (16, stereo 8-bit),
``BENCH_REPS`` (5).  Host clock, best of the reps after a warm-up.
"""

from __future__ import annotations

import time

import numpy as np

from bjxa_tpu_torch.benchmarks._common import bench_device, emit, env_int


def main() -> dict:
    from bjxa_tpu_torch.ops.decode import words_from_blocks_host
    from bjxa_tpu_torch.parallel.mesh import make_mesh
    from bjxa_tpu_torch.parallel.sharded import (
        decode_corpus_sharded_lanes,
        decode_corpus_sharded_words,
        host_flat,
    )

    device = bench_device()
    bits, channels = 8, 2
    B = env_int("BENCH_BLOCKS", 20672)
    L = env_int("BENCH_FILES", 16) * channels
    reps = env_int("BENCH_REPS", 5)
    S = bits * 4 + 1

    rng = np.random.default_rng(3)
    blocks_t = rng.integers(0, 256, size=(B, S, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (
        rng.integers(0, 5, size=(B, L)) << 4
        | rng.integers(0, 13, size=(B, L))
    ).astype(np.uint8)
    states = np.zeros((L, 2), np.int32)
    mesh = make_mesh([device], dp=1, sp=1)

    def run_lanes():
        pcm, _end, _valid = decode_corpus_sharded_lanes(
            blocks_t, states, bits=bits, mesh=mesh
        )
        return pcm.numpy()

    def run_words():
        prof, words = words_from_blocks_host(blocks_t, bits)
        shards, reassemble = decode_corpus_sharded_words(
            prof, words, states, bits=bits, mesh=mesh
        )
        return reassemble(host_flat(shards))

    lanes_out, words_out = run_lanes(), run_words()  # warm-up
    if lanes_out.shape != (B, 32, L) or not np.array_equal(lanes_out,
                                                           words_out):
        raise AssertionError("mesh_flat: the words and lanes paths differ")

    def best(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times), times

    t_lanes, lanes_runs = best(run_lanes)
    t_words, words_runs = best(run_words)
    pcm_bytes = B * 32 * L * 2
    return emit({
        "metric": "mesh_batch_seconds",
        "shape": f"[{B},{S},{L}]",
        "mesh": "1 device",
        "pcm_mb": pcm_bytes / 1e6,
        "lanes_3d_s": t_lanes,
        "words_flat_s": t_words,
        "lanes_3d_mb_s": pcm_bytes / t_lanes / 1e6,
        "words_flat_mb_s": pcm_bytes / t_words / 1e6,
        "speedup": t_lanes / t_words,
        "lanes_runs_s": lanes_runs,
        "words_runs_s": words_runs,
    }, device)


if __name__ == "__main__":
    main()
