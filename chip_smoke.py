#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bjxa_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

0. environment: the card, its power limit, torch and CUDA versions;
1. build the CUDA kernels from ``bjxa_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per source, all started together), with each kernel's
   registers and spills, and each instantiation of the variants kernel's
   registers, spills, shared memory and CTAs an SM (a spill in it, the
   words kernel, the load/store bound or the search's fixed point fails
   the run); then the native
   host library, the C ABI library and the C CLI of
   ``bjxa_tpu_torch/native`` with the host compiler, commands printed;
2. each kernel, every instantiation, against its plain PyTorch version on
   the card at the main paths' shapes and at ragged ones: exact equality;
   the words kernel's chunked schedule also against its chunked plain
   version, round counts included (ragged chunks, a slow-merging stream,
   B = 0, a persistent grid smaller than the work, K = 1, a corpus batch);
   the stream kernel, with and without output, against its chunked plain
   version
   (rounds included) and its sequential one (bits 4/6/8 x 1/2 channels at a
   prime block count, B = 0, a slow-merging stream, the 5-minute shape);
   the fused short-stream kernel against its sequential plain version
   (frames, end state, validity) and its chunked one (rounds) at every
   block count of the short path's checks x bits x channels x chunk size;
   the samples entry in both regimes (one CTA, one thread per lane);
   the search's fixed point (``csrc/encode_fixpoint.cu``) against its plain
   version, the host loop on the CPU (rounds included), at bits 4/6/8 x a
   short last chunk, ragged lanes, whole chunks of pad, K = 1 and B = 0;
   every instantiation of the load/store variants at forced and picked
   chunk counts, ragged lane counts and warps that straddle two chunks,
   against their chunked plain version (rounds included) and the words and
   lanes kernels; the channel-major wrappers on the card against the CPU:
   ``decode_arrays_fixpoint`` (the lanes kernel, rounds + 1 launches) at a
   prime block count for bits 4/6/8 x 1/2 channels and at the 5-minute
   stream's shape, ``decode_batch`` (one filter-kernel launch) on a
   32-file corpus batch;
3. known answers: the saturation vector's WAV SHA-1 (and the reference's
   golden fixtures when ``BJXA_REFERENCE_DIR`` points at them), the
   encoder's ranking-contract vectors, and an encode -> decode round trip
   that gives back the search's own reconstruction;
4. the main paths through the CLI (``python -m bjxa_tpu_torch decode``,
   ``encode`` and ``corpus [--encode]``, and ``decode``/``encode
   --segment-blocks``) on seeded synthetic streams, a
   5-minute stereo file and a 32-file corpus at full size among them,
   byte-compared with the port's plain path on the CPU (or, where the CPU
   would take too long, the card's per-file path, which the CPU checks on a
   few files, and for the 5-minute encode the card's own bytes, whose first
   100 s the CPU checks, and all of which the native host search of the
   streaming encoder checks); the launch counters show the in-process
   decode, encode and
   corpus runs went through every kernel of their path (a long whole-file
   decode is ONE stream-kernel launch, a short one ONE launch of the fused
   short-stream kernel, a segmented one a launch a segment,
   an oversized corpus file the same), the stream kernel's rounds equal
   its chunked plain version's at the card's K, and the encode's
   fixed point took as many rounds on the card as on the CPU (a long
   whole-file encode is ONE launch of the search's fixed point, whose rounds
   equal the host loop's, a short one one launch of the serial search); the
   encode corpus's batch is one launch of the fixed point, the serial
   search's launch over the batch gives the CLI's XA bytes and equals the
   plain search on the card over the first and last blocks of its batch;
   the fixed point equals the serial kernel byte for byte, its rounds the
   host loop's, at the corpus batch, an Encoder call and the 5-minute
   stream; the
   segmented path gives the whole-file bytes, decodes a file above the
   256 MB threshold at a smaller peak RSS than the whole-file path, and
   fails like the CPU on an invalid profile and a truncated body; the
   measurement scripts run in-process with their launches counted;
   ``decode --streaming`` of the 5-minute file gives the whole-file WAV,
   and a cut file and an invalid profile fail as the whole-file CPU run
   does; the streaming ``Encoder`` in a child process without the native
   library searches on the card (one launch of the search's fixed point a
   call, ~101 calls; again with the serial kernel alone) and gives the
   native library's bytes and ``encode``'s; ``abi --install``
   and a C client built against it through pkg-config decode the
   saturation vector, and the installed C CLI the 5-minute file; the
   multi-device layer on meshes that name the card more than once (their
   shards run one after another there): the sequence-parallel ring decode
   of the 5-minute stream on 1 and 4 entries and through
   ``decode_bytes(mesh=)`` (the lanes kernel in every round) gives
   ``xa_to_wav``'s PCM, with the ring's rounds equal to the CPU's on a
   cut of it, the ring encode of the 5-minute WAV on 4 entries (kernel 7
   in every round) ``wav_to_xa``'s bytes, the corpus engine on 2 entries
   the outputs and manifests of the runs without a mesh, and the transcode
   step on a (dp, cp) mesh the CPU's blocks and MSE, each path's launches
   counted from 0; ``decode``, ``encode`` and ``corpus --devices 1`` give
   the bytes of no flag, ``--devices 2`` exits 1 with the JAX package's
   text, and a two-process ``corpus`` (gloo on 127.0.0.1) the one-process
   outputs and totals;
5. timings on the card (CUDA events, median of repeats after warm-up), the
   per-stage split of each main path, the short-stream path (the launch
   floor of an empty kernel, the samples entry and the fused kernel in
   eager windows and in CUDA graphs, the fused kernel's chunk-size sweep,
   the step's cycles at the SM clock and each timing's chain floor, and a
   short ``xa_to_wav`` on the fused route and the old one with the device
   kernels of each from ``torch.profiler``), the stream kernel at the 5-minute
   stream (with and without output, a sweep of chunk sizes, its share of
   the measured
   load/store bound), the encoder's sequential search
   against its fixed point, the search's fixed point, the serial kernel
   and the host loop at the corpus batch, an Encoder call and the 5-minute
   stream (rounds, bounds, chain floors), the words kernel against the
   lanes kernel, over a sweep of chunk counts, the words kernel's share of
   the measured load/store bound at the headline shape, and the corpus
   engine end to end, split by the stages it times itself
   (``Counters.stage_ms``; the encode corpus also on the serial search
   alone); the
   measurement kernels against their plain versions and their bounds,
   the variants beside the words kernel at the scripts' shape and on a
   corpus batch, the ALU probe's six forms in CUDA graphs and eagerly with
   its int16/int32 rate ratio from the graphs; and
   ``python -m bjxa_tpu_torch.bench`` and the bound, variant and probe
   scripts as child processes, their JSON lines echoed; ``decode
   --streaming`` of the 5-minute file, the streaming Encoder's call on the
   card (the fixed point, and kernel 7 at two lanes) against the native
   host search, and ``benchmarks/abi.py``; the ring decode on 1 and 4
   entries
   and the ring encode on 4 (seconds, rounds, launches), the corpus
   decode and encode on 2 entries against none, and
   ``benchmarks/multihost.py`` (1 and 2 processes) and
   ``benchmarks/mesh_flat.py`` at a small size.

The line before the last is the kernel summary as JSON (each kernel's time
beside its plain version's and the least time the card could take for the
same bytes or operations); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20261016
DEVICE = "cuda"

# Kernel checks, (B, L): the main path's shape first (5-minute stereo file:
# 104 blocks per chunk over 4096 chunks x 2 channels), then ragged ones.
DECODE_SHAPES = ((104, 8192), (7, 8191), (1, 37))
# The samples entry's shapes: its two regimes, one CTA over shared memory
# for few lanes (64 x 2, 13 x 1) and one thread per lane for many.
FILTER_SHAPES = ((64, 2), (13, 1), (104, 8192))

# Streams through the CLI: name -> (bits, channels, samples).  The first is
# the full-size main-path file: 13,230,000 samples per channel, 413,438
# blocks, ~20.7 MB of XA and ~52.9 MB of PCM (one stream-kernel launch).
STREAMS = {
    "stereo6_5min": (6, 2, 44100 * 300),
    "mono4_60s": (4, 1, 44100 * 60),
    "mono8_60s": (8, 1, 44100 * 60),
    "stereo8_23blocks": (8, 2, 23 * 32 - 7),  # short path: filter kernel
}
# (bits, channels, samples, (block, channel) with an invalid profile)
BAD_STREAM = (6, 2, 44100 * 20, (12345, 1))

# Decoded-WAV SHA-1s of the reference's fixtures (tests/test_golden_decode.py).
GOLDEN = {
    "square-stereo-8.xa": "4b10d39db9abfb75bb3561d7a789ca5afb046c75",
    "square-mono-8.xa": "1c7bdc2f42bd87ebaceb8184312a1857a9f6d8de",
    "square-stereo-6.xa": "96eac5430bb7a73dc4801449684a4844b9b917c8",
    "square-mono-6.xa": "ce3991eda98db098e45e876944d8324302726a66",
    "square-stereo-4.xa": "35d8815e712737824c61a02f603145594c0827b7",
    "square-mono-4.xa": "064c48434d77d41c7df3030f3e4a85972dcbac80",
}

# Encode kernel checks, (B, L): the main path's round shape first (the
# 5-minute stereo WAV: 413,438 blocks over K = 4096 chunks x 2 channels,
# Bc = 101 blocks), then ragged ones.
ENCODE_SHAPES = ((101, 8192), (3, 37), (64, 1), (1, 2))
# Threads of one search CTA (csrc/encode_search.cu: 16 warps, one per range).
ENCODE_CTA_THREADS = 512

# WAVs through the CLI encoder: name -> (bits, channels, frames, flags).  The
# first is the full-size main-path stream: 13,230,000 frames, 413,438 blocks,
# 52.9 MB of PCM (whole-file fixed point, K = 4096, 8192 lanes).
ENCODE_STREAMS = {
    "stereo6_5min": (6, 2, 44100 * 300, []),
    "mono4_10s": (4, 1, 44100 * 10, ["--bits", "4"]),
    "mono8_10s": (8, 1, 44100 * 10, ["--bits", "8"]),
    "stereo8_23blocks": (8, 2, 23 * 32 - 7, ["--bits", "8"]),  # sequential
    "stereo6_20s_truncate": (6, 2, 44100 * 20, ["--truncate"]),
}
# Blocks of a WAV's head that the CPU encodes as the reference where the
# stream is longer (100 s of stereo: the plain search takes minutes on the
# 5-minute stream; the native host search of the streaming encoder checks
# the whole stream besides, in phase 4).
CPU_ENCODE_BLOCKS = 137813
# The mid-size stream: sequential search against the fixed point on the card.
MID_STREAM = (6, 2, 44100 * 20)
# A WAV whose body stops mid-frame, mid-block: (bits, channels, frames, kept
# body bytes).
CUT_WAV = (6, 2, 44100 * 20, 1234567)

# Stream-kernel checks, (B, channels, bits, K, stream): K forced, or None
# for the wrapper's own pick_stream_chunks (at B = 97: 13 chunks of 8, the
# last of 1 block; K = 7 leaves a last chunk of 13); "slow" is the
# slow-merging stream at K = B; the last is the 5-minute stream's shape.
STREAM_CHECKS = tuple(
    (97, channels, bits, chunks, "random")
    for bits in (4, 6, 8) for channels in (1, 2) for chunks in (None, 7)
) + ((0, 2, 6, None, "random"), (0, 1, 8, 3, "random"),
     (23, 2, 6, 23, "slow"), (23, 1, 4, 23, "slow"),
     (413438, 2, 6, None, "random"))
# Chunk sizes (blocks) timed at the 5-minute stream besides the wrapper's.
STREAM_BC_SWEEP = (8, 16, 32)
# The fused short-stream kernel: every block count of the short path's
# checks (1-15 and the odd counts that pick_chunks cannot split, up to 61)
# x bits {4, 6, 8} x channels {1, 2}, at chunks of Bc blocks for each Bc
# ("B": K = 1) and the wrapper's default, with and without output.
SHORT_BLOCKS = (1, 2, 7, 15, 17, 23, 25, 49, 61)
SHORT_BC = (1, 2, 4, 8, "B")
# Its timings: block counts x channels (8-bit), and the Bc sweep at each.
SHORT_TIMED = ((15, 1), (15, 2), (23, 1), (23, 2), (61, 1), (61, 2))
SHORT_BC_SWEEP = (1, 2, 3, 4, 8, "B")

# Words-kernel checks, (B, L, bits): the old bench.py headline first (16,384
# stereo 8-bit files x 64 blocks), then ragged shapes.
WORDS_SHAPES = ((64, 32768, 8), (7, 8191, 4), (7, 8191, 6), (300, 3, 4),
                (300, 3, 6))
# The words kernel's chunked schedule, (B, L, bits, K, stream): K forced, or
# None for the wrapper's own pick_word_chunks; "slow" is the slow-merging
# stream (factor 4, range 12, payload bytes near zero).  A prime B leaves a
# short last chunk; B = 300, L = 8191 at K = 37 has more work items than the
# persistent grid has threads; the last two are the headline (K = 1) and a
# corpus batch.
WORDS_CHUNKED = ((23, 33, 8, 7, "random"), (23, 33, 4, 23, "slow"),
                 (23, 33, 6, 23, "slow"), (23, 1, 6, 3, "random"),
                 (0, 1, 8, None, "random"), (1, 1, 4, 5, "random"),
                 (300, 8191, 4, 37, "random"), (300, 3, 6, 1, "random"),
                 (64, 32768, 8, None, "random"), (20736, 32, 8, None, "random"))
# Chunk counts timed on a corpus batch besides the wrapper's: B/8, B/16,
# B/32 and the serial loop (K = 1).
WORDS_K_SWEEP = (8, 16, 32)
# The corpus through the CLI, bench.py's corpus shape: 32 stereo 8-bit files
# of 20,672 blocks, 16 files a batch -> 2 batches of L = 32 lanes x 20,736
# blocks (43.7 MB of XA, 84.7 MB of PCM).
CORPUS = (32, 2, 8, 20672, 16)  # files, channels, bits, blocks, batch files
# Seconds of CPU reference decodes after which the rest of the corpus is
# compared with the card's per-file decode instead.
CORPUS_CPU_BUDGET_S = 20.0
# A small mixed directory, card against CPU: name -> (bits, channels,
# blocks, flaw), flaw "bad" (an invalid profile) or "cut" (truncated).
MIXED_CORPUS = {
    "m4_1": (4, 1, 700, None), "s4_2": (4, 2, 333, None),
    "m6_1": (6, 1, 1500, None), "s6_2": (6, 2, 900, None),
    "m8_1": (8, 1, 64, None), "s8_2": (8, 2, 2100, None),
    "bad": (6, 2, 800, "bad"), "cut": (8, 1, 500, "cut"),
}
# The encode corpus through the CLI: 16 stereo 10-second WAVs, 6-bit search
# (one batch: 13,782 blocks over 32 lanes), and two short WAVs compared
# with the CPU.
ENCODE_CORPUS = (16, 2, 441000)  # files, channels, frames
ENCODE_CORPUS_SHORT = ((2, 3000), (1, 4100))  # (channels, frames)
# The file of the encode corpus also encoded on the CPU (lanes 30-31 of its
# batch), and the blocks at each end of the batch that the plain search
# re-runs on the card against the batch's own kernel launch.
ENCODE_CORPUS_CPU_FILES = (15,)
ENCODE_CORPUS_PLAIN_BLOCKS = 128

# Stereo int16 saturation vector (tests/test_golden_decode.py): the left
# channel overflows, the right underflows.
SATURATION_XA = (
    "4b574431 42000000 20000000 44ac 08 02 00000000 0000 0000 0000 0000"
    " 00000000 20" + " 7f7f7f7f" * 8 + " 20" + " 80808080" * 8
)
SATURATION_WAV_SHA1 = "56ba3f62bf27ac9fd19cd97bcda06b4db327e612"


# Measurement-kernel checks, (B, L): the benchmark scripts' shape first
# (8-bit, 64 blocks x 32,768 lanes), then ragged ones.
VARIANT_SHAPES = ((64, 32768), (7, 8191), (300, 3))
# The variants kernel's chunked schedule, (B, L, K, offset): K forced, or
# None for the wrapper's own (the words kernel's pick_word_chunks); the u8
# blocks start `offset` bytes past a 16-byte boundary.  B = 23 is prime (a
# short last chunk unless K is 1 or 23); at L = 33, 129 and 8191 with K > 1
# warps straddle two chunks (their u8 lanes load alone), at L = 1 and 3
# every warp does; B = 300, L = 8191 at K = 37 has more work items than the
# persistent grid has threads; then a corpus batch, and blocks off a
# 16-byte boundary.
VARIANT_CHUNKED = tuple((23, L, K, 0) for L in (1, 3, 33, 129, 8191)
                        for K in (1, 2, 7, 23)) + (
    (0, 5, 4, 0), (300, 8191, 37, 0), (512, 32, None, 0),
    (20736, 32, None, 0), (23, 129, 1, 3), (23, 129, 7, 8),
    (23, 8191, 2, 15))
# The ALU probe's checks, (shape, offset in elements): the scripts' shape
# (None), a ragged one, odd and tiny counts, and views that start 1-7
# elements past a 16-byte boundary (int32 views take offsets 1-3).
ALU_SHAPES = ((None, 0), ((7, 8191), 0), ((1,), 0), ((3,), 0),
              ((2047,), 0)) + tuple(((4099,), k) for k in range(1, 8))
# The variants' second timed shape: a corpus batch, 16 stereo 8-bit files of
# 20,672 blocks (B padded to 20,736), the shape corpus runs launch.
VARIANT_CORPUS = (20736, 32)
# The segmented path: the CLI's default segment, and the file above the
# 256 MB threshold (benchmarks/segmented.py's size: 6-bit stereo, ~105 MB of
# XA and 268 MB of PCM).
SEGMENT_BLOCKS = 65536
BIG_BLOCKS = 2 * 1024 * 1024

# The streaming codec, the native host library, the C ABI and the
# channel-major wrappers.  decode_arrays_fixpoint is checked at a prime
# block count (K as pick_chunks gives it) for every bits x channels, then at
# the 5-minute stream's shape; decode_batch over a corpus batch (files,
# channels, bits, blocks) with the CPU's plain version decoding its first
# BATCH_CPU_BLOCKS blocks (the whole batch against the numpy oracle).
WRAPPER_BLOCKS = 1009
BATCH = (32, 2, 8, 20672)
BATCH_CPU_BLOCKS = 1024
# The streaming encoder is fed the 5-minute WAV in pieces of this many
# blocks (~101 calls, the carried state crossing each); runs of
# ``decode --streaming`` over the 5-minute file.
CODEC_PIECE_BLOCKS = 4096
STREAMING_RUNS = 3
# A mono 8-bit file of 1,200 blocks cut mid-block, after 1,000, for the
# streaming CLI's EOF case: (bits, channels, samples, kept bytes).
STREAM_CUT = (8, 1, 32 * 1200, 32 + 1000 * 33 + 17)

# The multi-device layer on one card: meshes that name the card more than
# once, whose shards run one after another there.  The ring decode of the
# 5-minute stream on these entry counts (K = 16 chunks a shard), its rounds
# checked against the CPU on a cut of SP_CUT_BLOCKS blocks; the ring encode
# of the 5-minute WAV on SP_ENCODE_ENTRIES; the corpus engine's decode and
# encode on DP_ENTRIES; the transcode step over a (dp, cp) = (2, 2) mesh of
# TRANSCODE = (files, channels, blocks) 6-bit streams, against the CPU.
SP_MESHES = (1, 4)
SP_CUT_BLOCKS = 4096
SP_ENCODE_ENTRIES = 4
DP_ENTRIES = 2
TRANSCODE = (4, 2, 256)
# The two scaling scripts in phase 5, at a small size.
MULTIHOST_ENV = {"BENCH_FILES": 8, "BENCH_SAMPLES": 66150,
                 "BENCH_BATCH_FILES": 4, "BENCH_PROCS": "1,2"}
MESH_FLAT_ENV = {"BENCH_REPS": 3}
# Said beside every time of a mesh that repeats the card.
SERIAL_NOTE = repr("shards of a repeated-device mesh run one after another"
                   " on one card")

# The card's peaks for the bounds.  Memory: the H100 SXM's published 3.35
# TB/s.  Integer operations: half of its published 67 TFLOP/s float32 rate,
# 33.5 T a second: that figure counts a fused multiply-add as two, so it is
# one instruction per lane per clock, which no mix of integer instructions
# can exceed either.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# The narrower per-pipe figure, reported beside the issue-rate bound as
# information: integer instructions are 64 results a clock an SM on compute
# capability 9.0 (the CUDA programming guide's throughput table), against
# its 128 issue slots.
INT_PIPE_OPS_PER_S = INT_OPS_PER_S / 2
# Integer instructions the arithmetic needs, a multiply-add counted as one.
# Decode, per sample: unpack 2 (shift, mask), sign extension 1, range shift
# 1, a multiply and a multiply-add 2, the truncating divide 4, the sum 1,
# the clamp 2; the filter kernel gets its samples unpacked.  Search, per
# candidate-sample: the 15 integer operations its source counts (its 2
# float operations are left out, which keeps the bound a lower one).
DECODE_OPS_PER_SAMPLE = 13
FILTER_OPS_PER_SAMPLE = 10
ENCODE_OPS_PER_CANDIDATE_SAMPLE = 15

#: The kernels of the port, by the names of their kernel functions
#: (``<name>_kernel``): each source's own name, and ``csrc/filter_lanes.cu``'s
#: fused short-stream decode and one-CTA filter besides.
KERNELS = ("decode_lanes", "filter_lanes", "encode_search", "decode_words",
           "decode_variants", "loadstore_bound", "alu_mix", "decode_stream",
           "decode_short", "filter_short", "encode_fixpoint")


def sha1(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


def phase(n: int, name: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase {n} {name}: {body}", flush=True)


def gpu_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 7, inner: int = 1) -> float:
    """Median milliseconds of one ``fn()`` over ``reps`` timed windows of
    ``inner`` calls each, by CUDA events, after one warm-up window."""
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def synth_xa(rng, bits: int, channels: int, samples: int, bad=None) -> bytes:
    """A valid XA file image: random payload bytes, valid profiles
    (factor 0-4, range 0-12), a random initial state; ``bad`` =
    (block, channel) gets an invalid profile factor."""
    from bjxa_tpu_torch import XAFormat, dump_xa_header

    blocks = -(-samples // 32)
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(blocks, channels)) << 4
        | rng.integers(0, 13, size=(blocks, channels))
    ).astype(np.uint8)
    if bad is not None:
        raw[bad[0], bad[1], 0] = 0x7A
    fmt = XAFormat(
        data_len=raw.size, samples=samples, samples_rate=44100, bits=bits,
        channels=channels, initial_state=((0, 0), (0, 0)),
    ).validate()
    hdr = bytearray(dump_xa_header(fmt))
    struct.pack_into(
        "<4h", hdr, 20, *rng.integers(-(2**15), 2**15, 4).tolist()
    )
    return bytes(hdr) + raw.tobytes()


def synth_wav(rng, channels: int, frames: int) -> bytes:
    """A canonical WAVE image of seeded audio-like PCM: two sines of random
    pitch per channel plus noise."""
    from bjxa_tpu_torch import dump_riff_header

    t = np.arange(frames, dtype=np.float64)[:, None] * (2 * np.pi / 44100)
    f = rng.uniform(80.0, 2000.0, size=(2, channels))
    sig = 9000 * np.sin(f[0] * t) + 4000 * np.sin(f[1] * t)
    sig += rng.normal(0.0, 400.0, size=(frames, channels))
    pcm = np.clip(sig, -32768, 32767).astype("<i2")
    return dump_riff_header(pcm.size * 2, 44100, channels) + pcm.tobytes()


def child_env(platform: str | None, **extra) -> dict:
    """The environment of a child process: the repository on the path, the
    CPU only when asked, none of the variables that change a route."""
    env = dict(os.environ)
    for name in ("BJXA_PLATFORM", "BJXA_ENCODE_FIXPOINT_CHUNKS",
                 "BJXA_SEGMENT_THRESHOLD"):
        env.pop(name, None)
    if platform:
        env["BJXA_PLATFORM"] = platform
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    env.update({k: str(v) for k, v in extra.items()})
    return env


def wav_head(wav: bytes, channels: int, frames: int) -> bytes:
    """The first ``frames`` frames of a canonical WAVE image, as a WAVE
    image of their own."""
    from bjxa_tpu_torch import dump_riff_header

    size = frames * channels * 2
    return dump_riff_header(size, 44100, channels) + wav[44:44 + size]


def run_cli(*args, platform: str | None):
    """``python -m bjxa_tpu_torch <args>`` in a child process."""
    return subprocess.run(
        [sys.executable, "-m", "bjxa_tpu_torch", *map(str, args)],
        cwd=ROOT, env=child_env(platform), capture_output=True, timeout=600,
    )


def run_cli_rss(*args, **env):
    """``python -m bjxa_tpu_torch <args>`` in a child process whose peak
    resident set is sampled from outside while it runs.  Returns ``(exit
    code, stderr, peak RSS in MB)``."""
    from bjxa_tpu_torch.benchmarks._common import PeakRss

    child = subprocess.Popen(
        [sys.executable, "-m", "bjxa_tpu_torch", *map(str, args)], cwd=ROOT,
        env=child_env(None, **env), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    with PeakRss(child.pid) as rss:
        _out, err = child.communicate(timeout=600)
    return child.returncode, err, rss.peak_mb


def file_sha1(path) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


def bound(bytes_moved: int, int_ops: int) -> tuple:
    """The least time the card could take, in ms, and what sets it: the
    bytes over the memory rate or the operations over the integer rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = int_ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def encode_bound(B: int, L: int) -> tuple:
    """``bound()`` of one search launch over ``B`` blocks x ``L`` lanes: the
    PCM read once, coded, recon, profiles and end state written once, or
    the integer operations of 80 candidates on every sample."""
    return bound(3 * B * 32 * L * 2 + B * L * 4 + 2 * L * 8,
                 B * 32 * L * 80 * ENCODE_OPS_PER_CANDIDATE_SAMPLE)


def exact_err(a, b) -> int:
    """Max |a - b| over two tensors that must be equal; raises if not."""
    e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if e or a.dtype != b.dtype or not a.equal(b):
        raise AssertionError(f"kernel and plain version differ by {e}")
    return e


#: ptxas' per-function lines, as (pattern, field) of ``ptxas_report``.
PTXAS_FIELDS = ((r"Used (\d+) registers", "registers"),
                (r"(\d+) bytes spill stores", "spill_bytes"),
                (r"(\d+) bytes spill loads", "spill_bytes"),
                (r"(\d+) bytes cumulative stack", "stack_bytes"),
                (r"(\d+) bytes stack frame", "stack_bytes"),
                (r"(\d+) bytes smem", "smem_bytes"))


def ptxas_report(log: str) -> dict:
    """``{kernel: {"registers": [...], "spill_bytes": n, "instances":
    {args: {"registers", "spill_bytes", "stack_bytes", "smem_bytes"}}}}``
    from the ``-Xptxas -v`` log: each kernel over every instantiation, and
    each instantiation keyed by its mangled template arguments
    (``ILi0ELi2EE`` is <0, 2>, "" for none); ``smem_bytes`` is the static
    shared memory."""
    out, rep = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = next((k for k in KERNELS if f"{k}_kernel" in line), None)
            rep = None
            if name is not None:
                m = re.search(rf"{name}_kernel(I(?:L[ib]\d+E)+E)?", line)
                rep = out.setdefault(name, {}).setdefault(
                    m.group(1) or "", dict.fromkeys(
                        ("registers", "spill_bytes", "stack_bytes",
                         "smem_bytes"), 0))
        if rep is None:
            continue
        for pat, field in PTXAS_FIELDS:
            m = re.search(pat, line)
            if m:
                rep[field] = max(rep[field], int(m.group(1)))
    return {k: {"registers": sorted({r["registers"] for r in v.values()}),
                "spill_bytes": max(r["spill_bytes"] for r in v.values()),
                "instances": v} for k, v in out.items()}


def variants_ptxas(lib, report: dict, device: int) -> dict:
    """Phase 1 for the variants kernel: each instantiation's ptxas report
    (of ``ptxas_report``), its ring's dynamic shared memory and its CTAs an
    SM, one line each; any spill of it, the words kernel or the bound fails
    the run."""
    from bjxa_tpu_torch.benchmarks import _variants

    entries = report["decode_variants"]["instances"]
    out = {}
    for load, lcode in _variants.LOADS.items():
        for store, (scode, _rows, _dtype) in _variants.STORES.items():
            if (load, store) == ("w32", "i32"):
                continue
            rep = dict(entries[f"ILi{lcode}ELi{scode}EE"],
                       dynamic_smem_bytes=lib.bjxa_decode_variant_smem(
                           lcode, scode),
                       ctas_per_sm=lib.bjxa_decode_variant_occupancy(
                           lcode, scode, device))
            out[f"{load}+{store}"] = rep
            phase(1, "decode_variants_ptxas", variant=f"{load}+{store}",
                  **rep)
    for name in ("decode_words", "loadstore_bound", "decode_variants"):
        if report[name]["spill_bytes"]:
            raise AssertionError(f"{name} spills: {report[name]}")
    return out


def check_kernels(torch, dev, rng):
    """Phase 2: both kernels, both instantiations, against their plain
    versions on the card.  Returns the max |kernel - plain| per kernel."""
    from bjxa_tpu_torch.ops import cuda_decode, cuda_filter
    from bjxa_tpu_torch.ops.filter import profile_gains

    def states(L):
        return torch.from_numpy(
            rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
        ).to(dev)

    err = exact_err
    worst = {"decode_lanes": 0, "filter_lanes": 0}
    for bits in (4, 6, 8):
        for B, L in DECODE_SHAPES:
            blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L),
                                    dtype=np.uint8)
            blocks_t[:, 0, :] = (
                rng.integers(0, 8, size=(B, L)) << 4
                | rng.integers(0, 16, size=(B, L))
            ).astype(np.uint8)
            bt = torch.from_numpy(blocks_t).to(dev)
            st = states(L)
            for wo in (True, False):
                pcm, end = cuda_decode.fused_decode_lanes(
                    bt, st, bits=bits, with_output=wo
                )
                ppcm, pend = cuda_decode.fused_decode_lanes_plain(
                    bt, st, bits=bits, with_output=wo
                )
                torch.cuda.synchronize()
                e = err(end, pend)
                if wo:
                    e = max(e, err(pcm, ppcm))
                elif pcm is not None:
                    raise AssertionError("states-only run returned PCM")
                worst["decode_lanes"] = max(worst["decode_lanes"], e)
    for B, L in FILTER_SHAPES:
        samples = torch.from_numpy(
            rng.integers(-(2**15), 2**15, size=(B, 32, L)).astype(np.int16)
        ).to(dev)
        prof = torch.from_numpy(
            (rng.integers(0, 8, size=(B, L)) << 4
             | rng.integers(0, 16, size=(B, L))).astype(np.int32)
        ).to(dev)
        k0, k1, shift, _ = profile_gains(prof)
        st = states(L)
        for wo in (True, False):
            pcm, end = cuda_filter.adpcm_filter_kernel(
                samples, k0, k1, shift, st, with_output=wo
            )
            ppcm, pend = cuda_filter.adpcm_filter_plain(
                samples, k0, k1, shift, st, with_output=wo
            )
            torch.cuda.synchronize()
            e = err(end, pend)
            if wo:
                e = max(e, err(pcm, ppcm))
            worst["filter_lanes"] = max(worst["filter_lanes"], e)
    return worst


def wav_lanes(torch, wav: bytes, device):
    """A WAVE image's PCM as ``wav_to_xa`` stages it: int16 ``[blocks, 32,
    channels]`` on ``device``, the last block zero-padded."""
    from bjxa_tpu_torch import (
        BLOCK_SAMPLES, RIFF_HEADER_SIZE, load_pcm, parse_riff_header,
    )

    rf = parse_riff_header(wav)
    pcm = load_pcm(wav[RIFF_HEADER_SIZE:RIFF_HEADER_SIZE + rf.data_len_pcm],
                   rf.channels)
    nblocks = -(-rf.samples // BLOCK_SAMPLES)
    padded = np.zeros((nblocks * BLOCK_SAMPLES, rf.channels), np.int16)
    padded[: rf.samples] = pcm
    return torch.from_numpy(
        padded.reshape(nblocks, BLOCK_SAMPLES, rf.channels)).to(device)


def encode_counted(torch, wav: bytes, bits: int, search: bool, device):
    """The port's whole-file encode of a WAVE image on ``device``, step by
    step as ``wav_to_xa`` takes it, with the search rounds counted through
    the fixed point's ``run`` parameter (which keeps its host loop, a
    search a round, on the card too).  Returns ``(xa bytes, rounds)``."""
    from bjxa_tpu_torch import XAFormat, dump_xa_header, parse_riff_header
    from bjxa_tpu_torch.ops import encode as tencode

    rf = parse_riff_header(wav)
    lanes = wav_lanes(torch, wav, device)
    rounds = []

    def run(lanes, states):
        rounds.append(len(rounds))
        return tencode.encode_search(lanes, states, bits=bits)

    blocks = tencode.encode_stream_blocks(lanes, bits=bits, search=search,
                                          run=run)
    payload = blocks.cpu().numpy().tobytes()
    fmt = XAFormat(
        data_len=len(payload), samples=rf.samples,
        samples_rate=rf.samples_rate, bits=bits, channels=rf.channels,
        initial_state=((0, 0), (0, 0)),
    ).validate()
    return dump_xa_header(fmt) + payload, len(rounds)


def tie_inputs(rng, B: int, L: int) -> list:
    """Inputs full of exact ties, as ``(pcm, state)`` numpy pairs: the
    ranking contract's multiples of 1024 from random entry states, and a
    constant per lane entered from its own value (its ties pit a lower
    range of a higher factor against a higher range of a lower factor, so a
    tie-break by range instead of candidate order shows there)."""
    ties = rng.integers(-14, 14, size=(B, 32, L)) * 1024
    ties_state = rng.integers(-(2**15), 2**15, size=(L, 2))
    c = rng.integers(-4096, 4097, size=L) >> rng.integers(0, 10, size=L)
    flat = np.ascontiguousarray(np.broadcast_to(c, (B, 32, L)))
    return [(ties, ties_state), (flat, np.stack([c, c], axis=-1))]


def check_encode_kernel(torch, dev, rng) -> int:
    """Phase 2 for the search kernel: every bit depth, the main path's
    round shape and ragged ones, full-scale noise and a sine plus noise
    from random entry states, and the tie-heavy inputs of ``tie_inputs``
    (from a stream of their own, so ``rng`` gives the later phases the
    inputs it gave them before).  Returns the max |kernel - plain| over
    profiles, coded values, reconstruction and end state."""
    from bjxa_tpu_torch.ops import cuda_encode

    tie_rng = np.random.default_rng(SEED + 5)
    worst = 0
    for bits in (4, 6, 8):
        for B, L in ENCODE_SHAPES:
            noise = rng.integers(-(2**15), 2**15, size=(B, 32, L))
            t = np.arange(B * 32)[:, None] * (2 * np.pi / 41.0)
            sine = (20000 * np.sin(t + np.arange(L))).reshape(B, 32, L)
            sine += rng.normal(0.0, 2000.0, size=(B, 32, L))
            cases = [(x, rng.integers(-(2**15), 2**15, size=(L, 2)))
                     for x in (noise, sine)]
            for x, state in cases + tie_inputs(tie_rng, B, L):
                pcm = torch.from_numpy(
                    np.clip(x, -32768, 32767).astype(np.int16)
                ).to(dev)
                st = torch.from_numpy(state.astype(np.int32)).to(dev)
                got = cuda_encode.encode_search_lanes(pcm, st, bits=bits)
                want = cuda_encode.encode_search_lanes_plain(pcm, st,
                                                             bits=bits)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    worst = max(worst, exact_err(g, w))
    return worst


#: The search's fixed point against its plain version in phase 2, (B, L,
#: K): a short last chunk, L not a multiple of 32 (tiles straddle chunks),
#: whole chunks of pad (Bc = 4), the least B that takes K > 1, K = 1 (the
#: pass with output alone), more tiles than the grid at small L, no blocks.
FIXPOINT_CHECKS = ((101, 2, 6), (101, 33, 7), (101, 2, 33), (64, 1, 4),
                   (37, 45, 1), (300, 3, 37), (0, 2, 1))


def check_encode_fixpoint_kernel(torch, dev, rng) -> int:
    """Phase 2 for the search's fixed point: every bit depth at the ragged
    shapes of ``FIXPOINT_CHECKS``, audio-like PCM from random entry states,
    against its plain version (the host loop over the plain search, on the
    CPU): all four outputs and the round count.  Returns the max |kernel -
    plain|."""
    from bjxa_tpu_torch.ops import cuda_encode

    worst = 0
    for bits in (4, 6, 8):
        for B, L, K in FIXPOINT_CHECKS:
            t = np.arange(B * 32)[:, None] * (2 * np.pi / 44100)
            f = rng.uniform(80.0, 2000.0, size=(2, L))
            x = 9000 * np.sin(f[0] * t) + 4000 * np.sin(f[1] * t)
            x += rng.normal(0.0, 600.0, size=(B * 32, L))
            pcm = np.clip(x, -32768, 32767).astype(np.int16).reshape(B, 32, L)
            state = rng.integers(-30000, 30000, size=(L, 2)).astype(np.int32)
            pcm_d = torch.from_numpy(pcm).to(dev)
            state_d = torch.from_numpy(state).to(dev)
            got = cuda_encode.encode_search_fixpoint_lanes(
                pcm_d, state_d, bits=bits, num_chunks=K)
            want = cuda_encode.encode_search_fixpoint_lanes_plain(
                torch.from_numpy(pcm), torch.from_numpy(state), bits=bits,
                num_chunks=K)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst = max(worst, exact_err(g.cpu(), w))
    return worst


def check_encode_fixpoint_shapes(torch, dev, enc: dict, corp: dict) -> dict:
    """Phase 4 for the search's fixed point at the three shapes of its
    main paths: the encode corpus's batch (B = 13,824, L = 32), a call of
    the streaming Encoder (the 5-minute stream's second 4,096-block piece,
    entered from its carried state) and the 5-minute stream (B = 413,438,
    L = 2).  At each, its one launch gives the serial kernel's four outputs
    byte for byte, and its rounds are the host loop's on the card (``run=``
    the serial kernel).  Returns the inputs and rounds for phase 5."""
    from functools import partial

    from bjxa_tpu_torch.ops import cuda_encode
    from bjxa_tpu_torch.ops import encode as tencode

    t0 = time.perf_counter()
    big = wav_lanes(torch, enc["big"], dev)
    piece = CODEC_PIECE_BLOCKS
    head = cuda_encode.encode_search_lanes(
        big[:piece].contiguous(), torch.zeros((2, 2), dtype=torch.int32,
                                              device=dev), bits=6)
    entry = torch.stack([head[2][-1, 31], head[2][-1, 30]], dim=-1).to(
        torch.int32).contiguous()
    lanes = corp["lanes"]
    shapes = {
        "corpus_batch": (lanes, torch.zeros((lanes.shape[2], 2),
                                            dtype=torch.int32, device=dev)),
        "encoder_call": (big[piece:2 * piece].contiguous(), entry),
        "5min": (big, torch.zeros((2, 2), dtype=torch.int32, device=dev)),
    }
    out = {}
    for name, (pcm, state) in shapes.items():
        B, _, L = pcm.shape
        K = tencode.pick_encode_chunks(B, L)
        serial = partial(cuda_encode.encode_search_lanes, bits=6)
        got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                       num_chunks=K)
        want = serial(pcm, state)
        for g, w in zip(got[:4], want):
            exact_err(g, w)
        *_, loop_rounds = tencode.encode_search_fixpoint(
            pcm, state, bits=6, num_chunks=K, run=serial)
        rounds = int(got[4].item())
        if rounds != loop_rounds:
            raise AssertionError(f"{name}: the kernel took {rounds} rounds,"
                                 f" the host loop {loop_rounds}")
        Bc = -(-B // K)
        out[name] = {"pcm": pcm, "state": state, "K": K, "Bc": Bc,
                     "rounds": rounds}
        phase(4, "encode_fixpoint_equals_serial", shape=name,
              B=B, L=L, K=K, Bc=Bc, items=K * L, rounds=rounds,
              host_loop_rounds=loop_rounds, outputs_equal=4)
    phase(4, "encode_fixpoint_shapes",
          seconds=f"{time.perf_counter() - t0:.3f}")
    return out


def encode_fixpoint_timings(torch, dev, gpu: str, shapes: dict) -> dict:
    """Phase 5 for the search's fixed point at its three shapes: its one
    launch, the serial kernel and the host loop (a serial launch and a
    sync a round; host clock), with rounds, the operations bound of one
    search of the same blocks (which counts no round) and the chain floor:
    (rounds + 1) passes x Bc blocks x the serial kernel's time a block on
    one CTA alone (at the Encoder's call, L = 2: one CTA), measured here.
    Its plain version (the host loop over the plain search, on the card) is
    timed once at the corpus batch.  Returns the numbers by shape."""
    from functools import partial

    from bjxa_tpu_torch.ops import cuda_encode
    from bjxa_tpu_torch.ops import encode as tencode

    t_all = time.perf_counter()
    out = {}
    for name, sh in shapes.items():
        pcm, state, K = sh["pcm"], sh["state"], sh["K"]
        B, _, L = pcm.shape
        fix = cuda_ms(torch, lambda: cuda_encode.encode_search_fixpoint_lanes(
            pcm, state, bits=6, num_chunks=K), reps=5)
        ser = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes(
            pcm, state, bits=6), reps=1 if B > 100000 else 3)
        serial = partial(cuda_encode.encode_search_lanes, bits=6)
        loop = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tencode.encode_search_fixpoint(pcm, state, bits=6, num_chunks=K,
                                           run=serial)
            torch.cuda.synchronize()
            loop.append((time.perf_counter() - t0) * 1e3)
        b_ms, b_by = encode_bound(B, L)
        out[name] = {"ms": fix, "serial_ms": ser,
                     "host_loop_ms": statistics.median(loop),
                     "bound_ms": b_ms, "bound_by": b_by,
                     **{k: sh[k] for k in ("K", "Bc", "rounds")}}
    block_ms = out["encoder_call"]["serial_ms"] / shapes["encoder_call"][
        "pcm"].shape[0]
    for name, r in out.items():
        r["chain_floor_ms"] = (r["rounds"] + 1) * r["Bc"] * block_ms
        phase(5, "time_encode_fixpoint", gpu=repr(gpu), shape=name,
              B=shapes[name]["pcm"].shape[0], L=shapes[name]["pcm"].shape[2],
              K=r["K"], Bc=r["Bc"], rounds=r["rounds"],
              kernel_ms=f"{r['ms']:.6f}", serial_ms=f"{r['serial_ms']:.6f}",
              host_loop_ms=f"{r['host_loop_ms']:.6f}",
              bound_ms=f"{r['bound_ms']:.6f}", bound_by=r["bound_by"],
              chain_floor_ms=f"{r['chain_floor_ms']:.6f}",
              one_cta_us_per_block=f"{block_ms * 1e3:.4f}")
    sh = shapes["corpus_batch"]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    cuda_encode.encode_search_fixpoint_lanes_plain(
        sh["pcm"], sh["state"], bits=6, num_chunks=sh["K"])
    stop.record()
    stop.synchronize()
    out["corpus_batch"]["plain_ms"] = start.elapsed_time(stop)
    phase(5, "time_encode_fixpoint_plain", gpu=repr(gpu),
          shape="corpus_batch",
          plain_ms=f"{out['corpus_batch']['plain_ms']:.3f}",
          seconds=f"{time.perf_counter() - t_all:.3f}")
    return out


def encode_known_answers(torch, dev, rng) -> None:
    """Phase 3 for the encoder: the ranking contract's vectors
    (tests/test_encode.py) and a round trip through the card's decode."""
    from bjxa_tpu_torch import wav_to_xa, xa_to_wav
    from bjxa_tpu_torch.ops import cuda_encode

    zeros = torch.zeros((16, 2), dtype=torch.int32, device=dev)
    ties = rng.integers(-14, 14, size=(1, 32, 16)) * 1024
    for pcm, want in ((ties, 0x00), (np.full((1, 32, 16), 1536), 0x01)):
        prof, *_ = cuda_encode.encode_search_lanes(
            torch.from_numpy(pcm.astype(np.int16)).to(dev), zeros, bits=6
        )
        if prof.cpu().reshape(-1).tolist() != [want] * 16:
            raise AssertionError(f"ranking contract: want profile {want}")
    frames = 200 * 32 + 9
    wav = synth_wav(rng, 2, frames)
    xa = wav_to_xa(wav, 6, device=dev)
    padded = np.zeros((201 * 32, 2), np.int16)
    padded[:frames] = np.frombuffer(wav[44:], "<i2").reshape(-1, 2)
    _p, _c, recon, _e = cuda_encode.encode_search_lanes(
        torch.from_numpy(padded.reshape(201, 32, 2)).to(dev),
        zeros[:2].contiguous(), bits=6,
    )
    back = np.frombuffer(xa_to_wav(xa, device=dev)[44:], "<i2")
    if not np.array_equal(back, recon.cpu().numpy().reshape(-1)[:2 * frames]):
        raise AssertionError("decode of the card's encode != its recon")
    phase(3, "encode_known_answers", rank_contract="match",
          round_trip="decode(encode) == recon", blocks=201)


def encode_main_path(torch, dev, rng) -> dict:
    """Phase 4 for the encoder: the CLI on the card against the port's
    plain path on the CPU (over the head of the 5-minute stream, over all
    of the others), with the fixed point's rounds equal on both; a
    cut WAV; the fixed point against the sequential search; and the main
    path in-process with its launches counted.  Returns what phase 5 and
    the summary need."""
    from bjxa_tpu_torch import parse_xa_header, wav_to_xa
    from bjxa_tpu_torch.ops import encode as tencode
    from bjxa_tpu_torch.ops.encode import pick_encode_chunks

    wavs, refs, rounds = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_enc_") as tmp:
        tmp = pathlib.Path(tmp)
        for name, (bits, channels, frames, flags) in ENCODE_STREAMS.items():
            wav = wavs[name] = synth_wav(rng, channels, frames)
            (tmp / f"{name}.wav").write_bytes(wav)
            search = "--truncate" not in flags
            # the CPU's reference: the whole stream, or the head of a longer
            # one (the search is causal, so the head of a stream encodes to
            # the head of its blocks)
            head = frames > 32 * CPU_ENCODE_BLOCKS
            cpu_wav = wav_head(wav, channels, 32 * CPU_ENCODE_BLOCKS) if head \
                else wav
            t0 = time.perf_counter()
            cpu_xa, cpu_rounds = encode_counted(torch, cpu_wav, bits, search,
                                                "cpu")
            cpu_s = time.perf_counter() - t0
            card, card_rounds = encode_counted(torch, cpu_wav, bits, search,
                                               dev)
            if card != cpu_xa or card_rounds != cpu_rounds:
                raise AssertionError(
                    f"{name}: card took {card_rounds} rounds, the CPU"
                    f" {cpu_rounds}; XA equal: {card == cpu_xa}")
            if head:
                refs[name], rounds[name] = encode_counted(torch, wav, bits,
                                                          search, dev)
                if refs[name][32:len(cpu_xa)] != cpu_xa[32:]:
                    raise AssertionError(f"{name}: the head of the card's XA"
                                         " != the CPU's XA of the head")
            else:
                refs[name], rounds[name] = cpu_xa, cpu_rounds
            res = run_cli("encode", *flags, tmp / f"{name}.wav",
                          tmp / f"{name}.xa", platform=None)
            if res.returncode != 0 or res.stderr:
                raise AssertionError(f"{name}: CLI exit {res.returncode}"
                                     f" {res.stderr.decode()[-2000:]}")
            if (tmp / f"{name}.xa").read_bytes() != refs[name]:
                raise AssertionError(f"{name}: CLI XA != reference XA")
            blocks = parse_xa_header(refs[name]).blocks
            phase(4, "cli_xa_equals_cpu", stream=name, blocks=blocks,
                  K=pick_encode_chunks(blocks, channels) if search else 1,
                  rounds=rounds[name], cpu_blocks=parse_xa_header(cpu_xa).blocks,
                  rounds_card=card_rounds, rounds_cpu=cpu_rounds,
                  xa_bytes=len(refs[name]), sha1=sha1(refs[name])[:12],
                  cpu_plain_s=f"{cpu_s:.3f}")

        # the 5-minute WAV in 65,536-block segments: the whole-file bytes
        t0 = time.perf_counter()
        res = run_cli("encode", "--segment-blocks", SEGMENT_BLOCKS,
                      tmp / "stereo6_5min.wav", tmp / "seg.xa", platform=None)
        if res.returncode != 0 or res.stderr:
            raise AssertionError(f"segmented encode: exit {res.returncode}"
                                 f" {res.stderr.decode()[-2000:]}")
        if (tmp / "seg.xa").read_bytes() != refs["stereo6_5min"]:
            raise AssertionError("segmented XA != whole-file XA")
        phase(4, "cli_segmented_xa_equals_whole_file", stream="stereo6_5min",
              segment_blocks=SEGMENT_BLOCKS,
              xa_bytes=len(refs["stereo6_5min"]),
              seconds=f"{time.perf_counter() - t0:.3f}")

        # a body cut mid-frame: exit 1, the reference's label and the same
        # prefix (header + whole blocks) on the card as on the CPU
        bits, channels, frames, kept = CUT_WAV
        cut = synth_wav(rng, channels, frames)[:44 + kept]
        (tmp / "cut.wav").write_bytes(cut)
        outs = {}
        for plat in (None, "cpu"):
            res = run_cli("encode", tmp / "cut.wav", tmp / f"cut_{plat}.xa",
                          platform=plat)
            if res.returncode != 1 or res.stderr != b"fread: End of file\n":
                raise AssertionError(f"cut WAV on {plat or 'cuda'}: exit"
                                     f" {res.returncode}"
                                     f" {res.stderr.decode()[-2000:]}")
            outs[plat] = (tmp / f"cut_{plat}.xa").read_bytes()
        whole = kept // (2 * channels) // 32
        if (outs[None] != outs["cpu"]
                or len(outs[None]) != 32 + whole * channels * (4 * bits + 1)):
            raise AssertionError("cut-WAV prefix differs")
        phase(4, "cli_cut_wav", exit=1, stderr=repr("fread: End of file"),
              whole_blocks=whole, prefix_bytes=len(outs[None]),
              equals_cpu=True)

    # the mid-size stream on the card: the fixed point gives the sequential
    # search's bytes
    bits, channels, frames = MID_STREAM
    mid = synth_wav(rng, channels, frames)
    mid_fix, mid_rounds = encode_counted(torch, mid, bits, True, dev)
    os.environ["BJXA_ENCODE_FIXPOINT_CHUNKS"] = "0"
    try:
        t0 = time.perf_counter()
        seq = wav_to_xa(mid, bits, device=dev)
        seq_s = time.perf_counter() - t0
    finally:
        del os.environ["BJXA_ENCODE_FIXPOINT_CHUNKS"]
    if seq != mid_fix:
        raise AssertionError("mid-size stream: fixed point and sequential"
                             " search bytes differ")
    nblocks = parse_xa_header(mid_fix).blocks
    phase(4, "fixpoint_equals_sequential", stream="stereo6_20s",
          blocks=nblocks, K=pick_encode_chunks(nblocks, channels),
          rounds=mid_rounds, sequential_bytes_equal=True)

    # the main path in-process, each encode counted from 0: the long stream
    # is ONE launch of the search's fixed point, the short one one launch
    # of the serial search, and nothing else launches
    big, short = wavs["stereo6_5min"], wavs["stereo8_23blocks"]
    got_big, _s, big_counts = counted(lambda: wav_to_xa(big, device=dev),
                                      "encode_fixpoint")
    got_short, _s, short_counts = counted(
        lambda: wav_to_xa(short, 8, device=dev), "encode_search")
    if got_big != refs["stereo6_5min"] or got_short != refs[
        "stereo8_23blocks"
    ]:
        raise AssertionError("in-process card XA != CPU XA")
    if big_counts["encode_fixpoint"] != 1 or short_counts[
            "encode_search"] != 1:
        raise AssertionError(f"the long encode launched {big_counts}, the"
                             f" short one {short_counts}")
    # the kernel's rounds equal the host loop's on the card (``rounds``:
    # encode_counted's run= keeps the loop there)
    big_rounds = rounds["stereo6_5min"]
    blocks = parse_xa_header(refs["stereo6_5min"]).blocks
    K = pick_encode_chunks(blocks, 2)
    lanes = wav_lanes(torch, big, dev)
    *_, kernel_rounds = tencode.encode_search_fixpoint(
        lanes, torch.zeros((2, 2), dtype=torch.int32, device=dev), bits=6,
        num_chunks=K)
    if kernel_rounds != big_rounds:
        raise AssertionError(f"fixed-point kernel: {kernel_rounds} rounds,"
                             f" the host loop {big_rounds}")
    phase(4, "encode_main_path_launches", K=K, Bc=-(-blocks // K),
          items=2 * K, rounds=big_rounds, host_loop_rounds=big_rounds,
          long=big_counts, short=short_counts)
    return {"big": big, "ref": refs["stereo6_5min"], "rounds": big_rounds,
            "K": K, "launches": short_counts["encode_search"],
            "fixpoint_launches": big_counts["encode_fixpoint"], "mid": mid,
            "seq_s": seq_s}


def encode_timings(torch, dev, gpu: str, enc: dict) -> tuple:
    """Phase 5 for the encoder: the kernel against its plain version at the
    main path's round shape, ``wav_to_xa`` end to end, the per-stage split
    and the sequential search against the fixed point.  Returns the
    kernel's and the plain version's ms."""
    from bjxa_tpu_torch import (
        BLOCK_SAMPLES, XAFormat, dump_xa_header, load_pcm, parse_riff_header,
        wav_to_xa,
    )
    from bjxa_tpu_torch.ops import cuda_encode
    from bjxa_tpu_torch.ops import encode as tencode
    from bjxa_tpu_torch.ops.deflate import deflate_blocks

    big, K = enc["big"], enc["K"]
    rf = parse_riff_header(big)
    C, nblocks = rf.channels, -(-rf.samples // BLOCK_SAMPLES)
    Bc = -(-nblocks // K)
    chunked = np.zeros((K * Bc * BLOCK_SAMPLES, C), np.int16)
    chunked[: rf.samples] = np.frombuffer(big[44:], "<i2").reshape(-1, C)
    lanes = torch.from_numpy(np.ascontiguousarray(
        chunked.reshape(K, Bc, BLOCK_SAMPLES, C).transpose(1, 2, 0, 3)
    ).reshape(Bc, BLOCK_SAMPLES, K * C)).to(dev)
    st = torch.zeros((K * C, 2), dtype=torch.int32, device=dev)
    k = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes(
        lanes, st, bits=6), inner=3)
    p = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes_plain(
        lanes, st, bits=6), reps=3)
    b_ms, b_by = encode_bound(Bc, K * C)
    phase(5, "time_encode_search", gpu=repr(gpu),
          shape=f"B={Bc},L={K * C},bits=6", kernel_ms=f"{k:.6f}",
          plain_ms=f"{p:.6f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by)
    # bench.py's shape: 32 blocks x 4096 lanes of full-scale noise
    bB, bL = 32, 4096
    noise = np.random.default_rng(SEED + 7).integers(
        -(2**15), 2**15, size=(bB, BLOCK_SAMPLES, bL))
    noise = torch.from_numpy(noise.astype(np.int16)).to(dev)
    zeros = torch.zeros((bL, 2), dtype=torch.int32, device=dev)
    kb = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes(
        noise, zeros, bits=6), inner=4)
    b_ms, b_by = encode_bound(bB, bL)
    phase(5, "time_encode_search_bench_shape", gpu=repr(gpu),
          shape=f"B={bB},L={bL},bits=6", kernel_ms=f"{kb:.6f}",
          bound_ms=f"{b_ms:.6f}", bound_by=b_by)

    e2e = []
    wav_to_xa(big, device=dev)
    for _ in range(5):
        t0 = time.perf_counter()
        wav_to_xa(big, device=dev)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    e2e_s = statistics.median(e2e)
    total = rf.samples * C
    phase(5, "time_wav_to_xa", gpu=repr(gpu), stream="stereo6_5min",
          samples=total, rounds=enc["rounds"], seconds=f"{e2e_s:.6f}",
          msamples_per_s=f"{total / e2e_s / 1e6:.3f}",
          runs=[f"{s:.6f}" for s in e2e])

    # where one encode's time goes, by stage (host clock, synchronized):
    # the search is one launch of its fixed point and the sync that reads
    # its round count
    stages = {k: [] for k in ("stage", "h2d", "search", "deflate", "d2h",
                              "header")}
    for _ in range(5):
        t = [time.perf_counter()]
        pcm = load_pcm(big[44:44 + rf.data_len_pcm], C)
        padded = np.zeros((nblocks * BLOCK_SAMPLES, C), np.int16)
        padded[: rf.samples] = pcm
        t.append(time.perf_counter())
        pcm_d = torch.from_numpy(
            padded.reshape(nblocks, BLOCK_SAMPLES, C)).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        prof, coded, _r, _e, rounds = tencode.encode_search_fixpoint(
            pcm_d, torch.zeros((C, 2), dtype=torch.int32, device=dev),
            bits=6, num_chunks=K)
        torch.cuda.synchronize()
        t_fix = time.perf_counter()
        blocks = deflate_blocks(prof, coded.transpose(1, 2), 6)
        torch.cuda.synchronize()
        t_def = time.perf_counter()
        payload = blocks.cpu().numpy()
        t_d2h = time.perf_counter()
        fmt = XAFormat(data_len=payload.size, samples=rf.samples,
                       samples_rate=rf.samples_rate, bits=6, channels=C,
                       initial_state=((0, 0), (0, 0))).validate()
        out = dump_xa_header(fmt) + payload.tobytes()
        t_hdr = time.perf_counter()
        if out != enc["ref"] or rounds != enc["rounds"]:
            raise AssertionError("staged encode XA != CPU XA")
        stages["stage"].append((t[1] - t[0]) * 1e3)
        stages["h2d"].append((t[2] - t[1]) * 1e3)
        stages["search"].append((t_fix - t[2]) * 1e3)
        stages["deflate"].append((t_def - t_fix) * 1e3)
        stages["d2h"].append((t_d2h - t_def) * 1e3)
        stages["header"].append((t_hdr - t_d2h) * 1e3)
    phase(5, "wav_to_xa_stages_ms", gpu=repr(gpu), rounds=enc["rounds"],
          **{k: f"{statistics.median(v):.3f}" for k, v in stages.items()})

    # sequential against the fixed point on the mid-size stream
    mid = enc["mid"]
    auto = []
    for _ in range(3):
        t0 = time.perf_counter()
        wav_to_xa(mid, device=dev)
        auto.append(time.perf_counter() - t0)
    mrf = parse_riff_header(mid)
    phase(5, "sequential_vs_auto", gpu=repr(gpu), stream="stereo6_20s",
          samples=mrf.samples * mrf.channels,
          sequential_s=f"{enc['seq_s']:.6f}",
          auto_s=f"{statistics.median(auto):.6f}",
          auto_runs=[f"{s:.6f}" for s in auto])
    return k, p


def stream_case(rng, B: int, channels: int, bits: int, slow: bool = False):
    """Seeded stream-kernel inputs in the file's byte layout: ``(payload
    uint8[B*C*S], state int32[C, 2])``, profile factors 0-7 (5 and up
    invalid) and random payload bytes, or (``slow``) the slow-merging
    stream (factor 4, range 12, payload bytes 0x00, 0x11, 0xEE or 0xFF)."""
    S = 4 * bits + 1
    raw = rng.integers(0, 256, size=(B, channels, S), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 8, size=(B, channels)) << 4
                    | rng.integers(0, 16, size=(B, channels))).astype(np.uint8)
    if slow:
        raw[:, :, 1:] = rng.choice(np.array([0x00, 0x11, 0xEE, 0xFF],
                                            np.uint8), size=(B, channels, S - 1))
        raw[:, :, 0] = 4 << 4 | 12
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    return raw.reshape(-1), state


def stream_equals_plains(torch, payload, state, bits: int, channels: int,
                         chunks, sequential: bool) -> tuple:
    """The stream kernel at ``chunks`` (None: the wrapper's own K), with
    output and states only, against its chunked plain
    version on the same tensors (frames, end state and rounds) and, where
    ``sequential``, its sequential plain version.  Returns ``(max |err|,
    rounds, rounds states-only, K, Bc)``; raises on any difference."""
    from bjxa_tpu_torch.ops import cuda_decode as cd

    B = payload.numel() // (channels * (4 * bits + 1))
    sms = torch.cuda.get_device_properties(payload.device).multi_processor_count
    K, Bc = (cd.word_chunks(B, chunks) if chunks is not None
             else cd.pick_stream_chunks(B, channels, sms))
    worst, got = 0, {}
    for wo in (True, False):
        frames, end, rounds = cd.fused_decode_stream(
            payload, state, bits=bits, channels=channels, with_output=wo,
            chunks=chunks)
        pframes, pend, prounds = cd.fused_decode_stream_chunked_plain(
            payload, state, bits=bits, channels=channels, chunks=K,
            with_output=wo)
        torch.cuda.synchronize()
        e = exact_err(end, pend)
        if wo:
            e = max(e, exact_err(frames, pframes))
        elif frames is not None:
            raise AssertionError("states-only run returned frames")
        if sequential:
            sframes, send = cd.fused_decode_stream_plain(
                payload, state, bits=bits, channels=channels, with_output=wo)
            torch.cuda.synchronize()
            e = max(e, exact_err(end, send))
            if wo:
                e = max(e, exact_err(frames, sframes))
        got[wo] = int(rounds.item())
        if got[wo] != prounds:
            raise AssertionError(
                f"stream kernel at B={B}, C={channels}, K={K}: {got[wo]}"
                f" rounds, the chunked plain version {prounds}")
        worst = max(worst, e)
    return worst, got[True], got[False], K, Bc


def short_case(rng, B: int, channels: int, bits: int):
    """Seeded fused-kernel inputs: ``(blocks uint8[C, B, S], state
    int32[C, 2])`` with random payload bytes, factors 0-4, ranges 0-15 and
    a random entry state; from 3 blocks on, the first quarter of the blocks
    saturates (factor 1, range 0, every sample the largest positive
    top-bits value in channel 0, the most negative in channel 1) and block
    B // 2 of the last channel has an invalid factor."""
    S = 4 * bits + 1
    raw = rng.integers(0, 256, size=(channels, B, S), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(channels, B)) << 4
                    | rng.integers(0, 16, size=(channels, B))).astype(np.uint8)
    if B >= 3:
        sat = max(1, B // 4)
        top = {4: ([0x77], [0x88]), 6: ([0x7D, 0xF7, 0xDF], [0x82, 0x08, 0x20]),
               8: ([0x7F], [0x80])}[bits]
        raw[:, :sat, 0] = 0x10
        for c in range(channels):
            raw[c, :sat, 1:] = np.resize(np.array(top[c], np.uint8), S - 1)
        raw[channels - 1, B // 2, 0] = 0x5A
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    return raw, state


def check_short_kernel(torch, dev, rng) -> int:
    """Phase 2 for the fused short-stream kernel (``SHORT_BLOCKS`` x bits
    x channels x ``SHORT_BC``): with and without output, its frames, end
    state and validity against the sequential plain version and its rounds
    against the chunked plain version at the same chunks, both on the CPU
    from the same inputs.  Returns the max |kernel - plain|."""
    from bjxa_tpu_torch.ops import cuda_filter as cf
    from bjxa_tpu_torch.ops.chunking import pick_short_chunks

    worst, cases, most_rounds = 0, 0, 0
    t0 = time.perf_counter()
    for bits in (4, 6, 8):
        for channels in (1, 2):
            for B in SHORT_BLOCKS:
                blocks, state = short_case(rng, B, channels, bits)
                bt, st = torch.from_numpy(blocks), torch.from_numpy(state)
                bd, sd = bt.to(dev), st.to(dev)
                want = cf.decode_short_plain(bt, st, bits=bits)
                for bc in SHORT_BC + (None,):  # None: the default chunks
                    chunks = (None if bc is None
                              else -(-B // (B if bc == "B" else bc)))
                    rounds = cf.decode_short_chunked_plain(
                        bt, st, bits=bits,
                        chunks=chunks or pick_short_chunks(B)[0],
                        with_output=False)[3]
                    for wo in (True, False):
                        frames, end, valid, r = cf.fused_decode_short(
                            bd, sd, bits=bits, chunks=chunks, with_output=wo)
                        torch.cuda.synchronize()
                        e = max(exact_err(end.cpu(), want[1]),
                                exact_err(valid.cpu(), want[2]))
                        if wo:
                            e = max(e, exact_err(frames.cpu(), want[0]))
                        elif frames is not None:
                            raise AssertionError("states-only run returned"
                                                 " frames")
                        if int(r.item()) != rounds:
                            raise AssertionError(
                                f"short kernel at B={B}, C={channels},"
                                f" chunks={chunks}: {int(r.item())} rounds,"
                                f" the chunked plain version {rounds}")
                        worst = max(worst, e)
                        most_rounds = max(most_rounds, rounds)
                        cases += 1
    phase(2, "short_equal_plain", cases=cases, blocks=list(SHORT_BLOCKS),
          bc=[str(b) for b in SHORT_BC], bits=[4, 6, 8], channels=[1, 2],
          most_rounds=most_rounds, max_abs_err=worst,
          seconds=f"{time.perf_counter() - t0:.3f}")
    return worst


def check_stream_kernel(torch, dev, rng) -> int:
    """Phase 2 for the stream kernel (``STREAM_CHECKS``).  Returns the max
    |kernel - plain|."""
    from bjxa_tpu_torch.ops import cuda_decode as cd

    worst = 0
    for B, channels, bits, chunks, stream in STREAM_CHECKS:
        payload, state = (torch.from_numpy(a).to(dev) for a in stream_case(
            rng, B, channels, bits, slow=stream == "slow"))
        sequential = B <= 2048  # the sequential plain version: B*32 steps
        e, rounds, rounds_s, K, Bc = stream_equals_plains(
            torch, payload, state, bits, channels, chunks, sequential)
        if stream == "slow" and not 2 < rounds <= K:
            raise AssertionError(f"slow-merging stream: {rounds} rounds")
        worst = max(worst, e)
        phase(2, "stream_equal_plain", shape=f"B={B},C={channels},bits={bits}",
              stream=stream, K=K, Bc=Bc, forced=chunks is not None,
              rounds=rounds, rounds_states_only=rounds_s, items=K * channels,
              grid_threads=cd.CTA_THREADS * cd.stream_ctas(
                  K * channels, bits=bits, channels=channels,
                  with_output=True, device=dev),
              sequential_checked=sequential)
    return worst


def words_case(rng, B: int, L: int, bits: int):
    """Seeded words-layout inputs: a profile plane with factors 0-7 (5 and
    up invalid), random payload words and int16-range states."""
    prof = (rng.integers(0, 8, size=(B, L)) << 4
            | rng.integers(0, 16, size=(B, L))).astype(np.uint8)
    words = rng.integers(-(2**31), 2**31, size=(B, bits, L), dtype=np.int32)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return prof, words, state


def slow_words_case(rng, B: int, L: int, bits: int):
    """The slow-merging stream in the words layout: factor 4 (the filter
    that forgets slowest), range 12, payload bytes of 0x00, 0x11, 0xEE or
    0xFF (tiny residuals), int16-range states."""
    prof = np.full((B, L), 4 << 4 | 12, np.uint8)
    pay = rng.choice(np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8),
                     size=(B, bits, 4, L))
    words = np.ascontiguousarray(pay.transpose(0, 1, 3, 2)).view("<i4")
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return prof, words.reshape(B, bits, L), state


def check_words_kernel(torch, dev, rng) -> int:
    """Phase 2 for the words kernel: both instantiations against the plain
    version at the bench.py headline shape and ragged ones, then the
    chunked schedule (``WORDS_CHUNKED``) against the chunked plain version,
    rounds included, and the sequential one where it is short.  Returns
    the max |kernel - plain|."""
    from bjxa_tpu_torch.ops import cuda_decode_words as cdw

    worst = 0
    for B, L, bits in WORDS_SHAPES:
        prof, words, state = (torch.from_numpy(a).to(dev)
                              for a in words_case(rng, B, L, bits))
        for wo in (True, False):
            pcm, end = cdw.fused_decode_words(prof, words, state, bits=bits,
                                              with_output=wo)
            ppcm, pend = cdw.fused_decode_words_plain(
                prof, words, state, bits=bits, with_output=wo)
            torch.cuda.synchronize()
            e = exact_err(end, pend)
            if wo:
                e = max(e, exact_err(pcm, ppcm))
            elif pcm is not None:
                raise AssertionError("states-only run returned PCM")
            worst = max(worst, e)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, L, bits, chunks, stream in WORDS_CHUNKED:
        make = slow_words_case if stream == "slow" else words_case
        prof, words, state = (torch.from_numpy(a).to(dev)
                              for a in make(rng, B, L, bits))
        K = chunks if chunks is not None else cdw.pick_word_chunks(B, L, sms)
        K, Bc = cdw.word_chunks(B, K)
        got_rounds = {}
        for wo in (True, False):
            pcm, end, rounds = cdw.fused_decode_words_chunked(
                prof, words, state, bits=bits, with_output=wo, chunks=chunks)
            ppcm, pend, prounds = cdw.fused_decode_words_chunked_plain(
                prof, words, state, bits=bits, chunks=K, with_output=wo)
            torch.cuda.synchronize()
            e = exact_err(end, pend)
            if wo:
                e = max(e, exact_err(pcm, ppcm))
            if B <= 2048:  # the sequential plain version: B*32 steps
                spcm, send = cdw.fused_decode_words_plain(
                    prof, words, state, bits=bits, with_output=wo)
                torch.cuda.synchronize()
                e = max(e, exact_err(end, send))
                if wo:
                    e = max(e, exact_err(pcm, spcm))
            got_rounds[wo] = int(rounds.item())
            if got_rounds[wo] != prounds:
                raise AssertionError(
                    f"words kernel at B={B}, L={L}, K={K}: {got_rounds[wo]}"
                    f" rounds, the chunked plain version {prounds}")
            worst = max(worst, e)
        if stream == "slow" and not 2 < got_rounds[True] <= K:
            raise AssertionError(f"slow-merging stream: {got_rounds} rounds")
        phase(2, "words_chunked_equal_plain", shape=f"B={B},L={L},bits={bits}",
              stream=stream, K=K, Bc=Bc, forced=chunks is not None,
              rounds=got_rounds[True], rounds_states_only=got_rounds[False],
              items=K * L, grid_threads=cdw.CTA_THREADS * cdw.persistent_ctas(
                  K * L, bits=bits, with_output=True, device=dev),
              sequential_checked=B <= 2048)
    return worst


def write_corpus(rng, src: pathlib.Path) -> list:
    """The bench.py corpus (bench.py:132-154), drawn from ``rng``: full
    samples, valid random profiles.  Returns the file names."""
    from bjxa_tpu_torch import XAFormat, dump_xa_header

    n_files, channels, bits, nblocks, _batch = CORPUS
    size = 4 * bits + 1
    hdr = dump_xa_header(XAFormat(
        data_len=nblocks * size * channels, samples=nblocks * 32,
        samples_rate=44100, bits=bits, channels=channels,
        initial_state=((0, 0), (0, 0)),
    ).validate())
    names = []
    for i in range(n_files):
        body = rng.integers(0, 256, nblocks * channels * size,
                            dtype=np.uint8).reshape(nblocks * channels, size)
        body[:, 0] = (body[:, 0] & 0x0F) | (
            rng.integers(0, 5, nblocks * channels).astype(np.uint8) << 4)
        names.append(f"f{i:04d}")
        (src / f"f{i:04d}.xa").write_bytes(hdr + body.tobytes())
    return names


def corpus_main_path(torch, dev, rng, tmp: pathlib.Path) -> dict:
    """Phase 4 for the corpus engine: the 32-file corpus through ``python -m
    bjxa_tpu_torch corpus`` against per-file references, a rerun that skips
    everything, the in-process run with its launches counted, and a mixed
    directory on the card against the CPU.  Returns what phase 5 needs."""
    from bjxa_tpu_torch import decode_corpus, xa_to_wav
    from bjxa_tpu_torch.ops import (cuda_decode, cuda_decode_words,
                                    cuda_encode, cuda_filter)

    t_phase = time.perf_counter()
    n_files, channels, bits, nblocks, batch = CORPUS
    src = tmp / "corpus_xa"
    src.mkdir()
    names = write_corpus(rng, src)
    res = run_cli("corpus", "--batch-files", batch, src, tmp / "corpus_wav",
                  platform=None)
    if res.returncode != 0 or res.stderr:
        raise AssertionError(f"corpus CLI exit {res.returncode}"
                             f" {res.stderr.decode()[-2000:]}")
    want_out = f"converted {n_files} skipped 0 failed 0"
    if not res.stdout.decode().startswith(want_out):
        raise AssertionError(f"corpus CLI said {res.stdout!r}")
    # references: the port's per-file decode on the CPU while it stays in
    # budget, then the card's per-file decode (itself held against the CPU
    # on the files before)
    cpu_refs = card_refs = 0
    t0 = time.perf_counter()
    for name in names:
        xa = (src / f"{name}.xa").read_bytes()
        if time.perf_counter() - t0 < CORPUS_CPU_BUDGET_S:
            want = xa_to_wav(xa, device="cpu")
            cpu_refs += 1
        else:
            want = xa_to_wav(xa, device=dev)
            card_refs += 1
        if (tmp / "corpus_wav" / f"{name}.wav").read_bytes() != want:
            raise AssertionError(f"corpus {name}: CLI WAV != reference")
    cpu_s = time.perf_counter() - t0
    if cpu_refs < 4:
        raise AssertionError(f"only {cpu_refs} CPU references in budget")
    again = run_cli("corpus", "--batch-files", batch, src,
                    tmp / "corpus_wav", platform=None)
    if again.returncode != 0 or not again.stdout.decode().startswith(
        f"converted 0 skipped {n_files} failed 0"
    ):
        raise AssertionError(f"corpus rerun: {again.stdout!r}"
                             f" {again.stderr.decode()[-2000:]}")
    phase(4, "cli_corpus_equals_reference", files=n_files, blocks=nblocks,
          batch_files=batch, cpu_refs=cpu_refs, card_refs=card_refs,
          ref_s=f"{cpu_s:.3f}", rerun_skipped=n_files,
          seconds=f"{time.perf_counter() - t_phase:.3f}")

    # the corpus path in-process, counted: one words-kernel launch a batch
    mods = (cuda_decode, cuda_decode_words, cuda_encode, cuda_filter)
    for mod in mods:
        mod.LAUNCHES = 0
    run = decode_corpus(src, tmp / "corpus_wav_inproc", device=dev,
                        batch_files=batch)
    launches = cuda_decode_words.LAUNCHES
    batches = -(-n_files // batch)
    if run.converted != n_files or run.failed or launches != batches:
        raise AssertionError(f"in-process corpus: {run.converted} converted,"
                             f" {run.failed}, words kernel launched"
                             f" {launches} times for {batches} batches")
    for name in names:
        if ((tmp / "corpus_wav_inproc" / f"{name}.wav").read_bytes()
                != (tmp / "corpus_wav" / f"{name}.wav").read_bytes()):
            raise AssertionError(f"corpus {name}: in-process WAV != CLI WAV")
    phase(4, "corpus_main_path_launches", batches=batches,
          lanes=batch * channels, decode_words=launches,
          decode_lanes=cuda_decode.LAUNCHES, filter_lanes=cuda_filter.LAUNCHES,
          encode_search=cuda_encode.LAUNCHES)

    # a mixed directory: the same exit code, stdout, stderr and bytes on
    # the card and on the CPU
    t_mixed = time.perf_counter()
    mixed = tmp / "mixed_xa"
    mixed.mkdir()
    for name, (mbits, mch, mblocks, flaw) in MIXED_CORPUS.items():
        img = synth_xa(rng, mbits, mch, mblocks * 32 - 3,
                       bad=(mblocks // 2, mch - 1) if flaw == "bad" else None)
        (mixed / f"{name}.xa").write_bytes(img[:-50] if flaw == "cut"
                                           else img)
    runs = {}
    for plat in (None, "cpu"):
        out = tmp / f"mixed_wav_{plat}"
        r = run_cli("corpus", "--batch-files", 2, mixed, out, platform=plat)
        runs[plat] = (r.returncode, r.stdout, r.stderr,
                      {p.name: p.read_bytes() for p in out.glob("*.wav")})
    flawed = sum(1 for v in MIXED_CORPUS.values() if v[3])
    if runs[None] != runs["cpu"] or runs[None][0] != 1 or len(
        runs[None][3]
    ) != len(MIXED_CORPUS) - flawed:
        raise AssertionError(f"mixed corpus: card {runs[None][:3]} vs CPU"
                             f" {runs['cpu'][:3]}")
    phase(4, "cli_corpus_mixed_equals_cpu", exit=1, files=len(MIXED_CORPUS),
          failed=flawed, stdout=repr(runs[None][1].decode().strip()),
          seconds=f"{time.perf_counter() - t_mixed:.3f}")
    return {"src": src, "names": names, "launches": launches}


def stage_encode_corpus(torch, dev, src: pathlib.Path):
    """The encode corpus as ``encode_corpus`` stages its one batch: int16
    ``[Bs, 32, files x channels]`` on the card, ``Bs`` the block count
    rounded up to the bucket granularity (256)."""
    from bjxa_tpu_torch import load_pcm, parse_riff_header

    n_files, channels, frames = ENCODE_CORPUS
    nblocks = -(-frames // 32)
    Bs = -(-nblocks // 256) * 256
    staged = np.zeros((Bs * 32, n_files * channels), np.int16)
    for i in range(n_files):
        wav = (src / f"w{i:02d}.wav").read_bytes()
        rf = parse_riff_header(wav)
        staged[:frames, i * channels:(i + 1) * channels] = load_pcm(
            wav[44:44 + rf.data_len_pcm], channels)
    return torch.from_numpy(staged.reshape(Bs, 32, -1)).to(dev)


def check_encode_corpus_batch(torch, dev, src: pathlib.Path,
                              out: pathlib.Path) -> tuple:
    """The search kernel at the encode corpus's launch shape: one launch
    over the staged batch, whose deflated blocks must be the CLI's XA
    payloads, held against the plain search on the card over the first and
    the last ``ENCODE_CORPUS_PLAIN_BLOCKS`` blocks (the last entered from
    the state the kernel's own reconstruction carries there).  Returns
    ``(staged batch, max |kernel - plain|)``."""
    from bjxa_tpu_torch.ops import cuda_encode
    from bjxa_tpu_torch.ops.deflate import deflate_blocks

    n_files, channels, frames = ENCODE_CORPUS
    lanes = stage_encode_corpus(torch, dev, src)
    Bs, _, L = lanes.shape
    zeros = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    got = cuda_encode.encode_search_lanes(lanes, zeros, bits=6)
    blocks = deflate_blocks(got[0], got[1].transpose(1, 2), 6).cpu().numpy()
    nblocks = -(-frames // 32)
    for i in range(n_files):
        payload = np.ascontiguousarray(
            blocks[:nblocks, i * channels:(i + 1) * channels]).tobytes()
        if (out / f"w{i:02d}.xa").read_bytes()[32:] != payload:
            raise AssertionError(f"encode corpus w{i:02d}: XA != the batch"
                                 " launch's blocks")
    P = ENCODE_CORPUS_PLAIN_BLOCKS
    worst = 0
    for lo in (0, Bs - P):
        entry = zeros if lo == 0 else torch.stack(
            [got[2][lo - 1, 31], got[2][lo - 1, 30]], dim=-1).to(torch.int32)
        want = cuda_encode.encode_search_lanes_plain(
            lanes[lo:lo + P].contiguous(), entry.contiguous(), bits=6)
        hi = lo + P
        exit_state = got[3] if hi == Bs else torch.stack(
            [got[2][hi - 1, 31], got[2][hi - 1, 30]], dim=-1).to(torch.int32)
        for g, w in zip((got[0][lo:hi], got[1][lo:hi], got[2][lo:hi],
                         exit_state), want):
            worst = max(worst, exact_err(g, w))
    return lanes, worst


def encode_corpus_main_path(torch, dev, rng, tmp: pathlib.Path) -> dict:
    """Phase 4 for the corpus encode: 16 stereo 10-second WAVs through
    ``python -m bjxa_tpu_torch corpus --encode`` against the card's
    per-file ``wav_to_xa`` and, for two of them, the CPU's; two short WAVs
    on the card against the CPU; the in-process run with its launches
    counted; and the kernel at the batch's shape against its plain
    version."""
    from bjxa_tpu_torch import encode_corpus, wav_to_xa

    t_phase = time.perf_counter()
    n_files, channels, frames = ENCODE_CORPUS
    src = tmp / "enc_wav"
    src.mkdir()
    for i in range(n_files):
        (src / f"w{i:02d}.wav").write_bytes(synth_wav(rng, channels, frames))
    res = run_cli("corpus", "--encode", src, tmp / "enc_xa", platform=None)
    if res.returncode != 0 or res.stderr or not res.stdout.decode(
    ).startswith(f"converted {n_files} skipped 0 failed 0"):
        raise AssertionError(f"encode corpus CLI exit {res.returncode}"
                             f" {res.stdout!r} {res.stderr.decode()[-2000:]}")
    for i in range(n_files):
        want = wav_to_xa((src / f"w{i:02d}.wav").read_bytes(), device=dev)
        if (tmp / "enc_xa" / f"w{i:02d}.xa").read_bytes() != want:
            raise AssertionError(f"encode corpus w{i:02d}: XA != wav_to_xa")
    t_cpu = time.perf_counter()
    for i in ENCODE_CORPUS_CPU_FILES:
        want = wav_to_xa((src / f"w{i:02d}.wav").read_bytes(), device="cpu")
        if (tmp / "enc_xa" / f"w{i:02d}.xa").read_bytes() != want:
            raise AssertionError(f"encode corpus w{i:02d}: XA != the CPU's")
    cpu_s = time.perf_counter() - t_cpu
    # two short WAVs: the CLI on the card and on the CPU
    short = tmp / "enc_short"
    short.mkdir()
    for i, (ch, fr) in enumerate(ENCODE_CORPUS_SHORT):
        (short / f"s{i}.wav").write_bytes(synth_wav(rng, ch, fr))
    outs = {}
    for plat in (None, "cpu"):
        r = run_cli("corpus", "--encode", short, tmp / f"enc_short_{plat}",
                    platform=plat)
        if r.returncode != 0 or r.stderr:
            raise AssertionError(f"short encode corpus on {plat or 'cuda'}:"
                                 f" {r.returncode} {r.stderr.decode()}")
        outs[plat] = {p.name: p.read_bytes()
                      for p in (tmp / f"enc_short_{plat}").glob("*.xa")}
    if outs[None] != outs["cpu"] or len(outs[None]) != 2:
        raise AssertionError("short encode corpus: card XA != CPU XA")
    # the batch is one launch of the search's fixed point and nothing else
    run, _secs, got = counted(
        lambda: encode_corpus(src, tmp / "enc_xa_inproc", device=dev),
        "encode_fixpoint")
    launches = got["encode_fixpoint"]
    if run.converted != n_files or run.failed or launches != 1:
        raise AssertionError(f"in-process encode corpus: {run.converted},"
                             f" {run.failed}, {got}")
    for i in range(n_files):
        if ((tmp / "enc_xa_inproc" / f"w{i:02d}.xa").read_bytes()
                != (tmp / "enc_xa" / f"w{i:02d}.xa").read_bytes()):
            raise AssertionError(f"encode corpus w{i:02d}: in-process != CLI")
    nblocks = -(-frames // 32)
    phase(4, "cli_corpus_encode_equals_wav_to_xa", files=n_files,
          blocks=nblocks, lanes=n_files * channels, encode_fixpoint=launches,
          encode_search=got["encode_search"],
          decode_words=got["decode_words"],
          cpu_files=list(ENCODE_CORPUS_CPU_FILES), cpu_s=f"{cpu_s:.3f}",
          short_equals_cpu=True,
          seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_batch = time.perf_counter()
    lanes, err = check_encode_corpus_batch(torch, dev, src, tmp / "enc_xa")
    phase(4, "encode_corpus_batch_equals_plain",
          shape=f"B={lanes.shape[0]},L={lanes.shape[2]},bits=6",
          plain_blocks=f"{ENCODE_CORPUS_PLAIN_BLOCKS}+"
                       f"{ENCODE_CORPUS_PLAIN_BLOCKS}",
          xa_equals_launch=True, max_abs_err=err,
          seconds=f"{time.perf_counter() - t_batch:.3f}")
    return {"src": src, "launches": launches, "lanes": lanes, "err": err}


def stage_split(runs) -> dict:
    """Median over corpus runs of each stage's ms (``Counters.stage_ms``),
    of the run's own elapsed ms, and of the device's busy share: the
    event-timed upload, compute and readback over the elapsed time."""
    keys = sorted(set().union(*(c.stage_ms for c in runs)))
    out = {k: f"{statistics.median(c.stage_ms.get(k, 0.0) for c in runs):.3f}"
           for k in keys}
    out["elapsed"] = f"{statistics.median(c.elapsed() * 1e3 for c in runs):.3f}"
    out["device_busy"] = "{:.4f}".format(statistics.median(
        sum(c.stage_ms[k] for k in ("h2d", "compute", "d2h"))
        / (c.elapsed() * 1e3) for c in runs))
    return out


def corpus_timings(torch, dev, gpu: str, corp: dict, enc: dict,
                   tmp: pathlib.Path) -> tuple:
    """Phase 5 for the corpus engine: the words kernel against its plain
    version at the headline shape, against the lanes kernel on one corpus
    batch, the packed H2D against three, and ``decode_corpus`` and
    ``encode_corpus`` end to end and by the stages they time themselves
    (``encode_corpus`` on its route and on the serial search kernel alone).
    Returns the words kernel's
    and its plain version's ms at the headline shape, with and without
    output, and the corpus batch's numbers."""
    import shutil

    from bjxa_tpu_torch import decode_corpus, encode_corpus, parse_xa_header
    from bjxa_tpu_torch.ops import cuda_decode, cuda_decode_words as cdw
    from bjxa_tpu_torch.ops import decode as tdecode
    from bjxa_tpu_torch.parallel.corpus import stage_decode_batch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    B, L, bits = WORDS_SHAPES[0]
    prof, words, state = (torch.from_numpy(a).to(dev)
                          for a in words_case(rng, B, L, bits))
    ms = {}
    for wo in (True, False):
        k = cuda_ms(torch, lambda: cdw.fused_decode_words(
            prof, words, state, bits=bits, with_output=wo), inner=20)
        p = cuda_ms(torch, lambda: cdw.fused_decode_words_plain(
            prof, words, state, bits=bits, with_output=wo), reps=3)
        ms[wo] = (k, p)
        moved = B * L * (4 * bits + 1) + (B * 32 * L * 2 if wo else 0)
        _p, _e, rounds = cdw.fused_decode_words_chunked(
            prof, words, state, bits=bits, with_output=wo)
        phase(5, "time_decode_words", gpu=repr(gpu),
              shape=f"B={B},L={L},bits={bits}", with_output=wo,
              K=cdw.pick_word_chunks(B, L, torch.cuda.get_device_properties(
                  dev).multi_processor_count), rounds=int(rounds.item()),
              kernel_ms=f"{k:.6f}", plain_ms=f"{p:.6f}",
              mbytes=f"{moved / 1e6:.3f}",
              gb_per_s=f"{moved / (k * 1e-3) / 1e9:.3f}")

    # one corpus batch: the words kernel and the lanes kernel on the same
    # staged bytes (no plain version: a Python loop of ~663 k steps here)
    n_files, channels, cbits, nblocks, batch = CORPUS
    src, names = corp["src"], corp["names"]
    def headers():
        out = []
        for n in names:
            with open(src / f"{n}.xa", "rb") as f:
                out.append((src / f"{n}.xa", parse_xa_header(f.read(32))))
        return out

    fmts = headers()
    Bs = -(-nblocks // 256) * 256
    Lc = batch * channels
    buf, _valid, _dead = stage_decode_batch(fmts[:batch], cbits, channels, Bs,
                                            Lc, {}, dev)
    nw, npr, nst = tdecode.packed_layout(Bs, Lc, cbits)
    dbuf = buf.to(dev)
    cwords = dbuf[:nw].reshape(Bs, cbits, Lc)
    cprof = dbuf[nw:nw + npr].view(torch.uint8)[:Bs * Lc].reshape(Bs, Lc)
    cstate = dbuf[nw + npr:].reshape(Lc, 2)
    blocks_t = tdecode.words_to_blocks(cprof, cwords, bits=cbits).contiguous()
    kw = cuda_ms(torch, lambda: cdw.fused_decode_words(
        cprof, cwords, cstate, bits=cbits), reps=7, inner=20)
    kl = cuda_ms(torch, lambda: cuda_decode.fused_decode_lanes(
        blocks_t, cstate, bits=cbits), reps=5)
    got_w, end_w, rounds_w = cdw.fused_decode_words_chunked(
        cprof, cwords, cstate, bits=cbits)
    got_l, end_l = cuda_decode.fused_decode_lanes(blocks_t, cstate,
                                                  bits=cbits)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K = cdw.pick_word_chunks(Bs, Lc, sms)
    got_p, end_p, rounds_p = cdw.fused_decode_words_chunked_plain(
        cprof, cwords, cstate, bits=cbits, chunks=K)
    torch.cuda.synchronize()
    for want, want_end in ((got_l, end_l), (got_p, end_p)):
        exact_err(got_w, want)
        exact_err(end_w, want_end)
    if int(rounds_w.item()) != rounds_p:
        raise AssertionError(f"corpus batch: {int(rounds_w.item())} rounds,"
                             f" the chunked plain version {rounds_p}")
    from bjxa_tpu_torch.benchmarks.roofline_bound import words_traffic

    b_ms, b_by = bound(words_traffic(Bs, Lc, cbits),
                       Bs * 32 * Lc * DECODE_OPS_PER_SAMPLE)
    phase(5, "time_words_vs_lanes_corpus_batch", gpu=repr(gpu),
          shape=f"B={Bs},L={Lc},bits={cbits}", K=K,
          Bc=cdw.word_chunks(Bs, K)[1], rounds=rounds_p,
          words_ms=f"{kw:.6f}", lanes_ms=f"{kl:.6f}",
          lanes_over_words=f"{kl / kw:.4f}", outputs_equal=True,
          words_bound_ms=f"{b_ms:.6f}", bound_by=b_by,
          share_of_bound=f"{b_ms / kw:.4f}")
    # the chunk count: B/8, B/16, B/32 and the serial loop (K = 1), timed
    # in turns, each with its rounds
    sweep = {}
    for div in (*WORDS_K_SWEEP, None):
        k = Bs // div if div else 1
        for wo in (True, False):
            t = cuda_ms(torch, lambda: cdw.fused_decode_words_chunked(
                cprof, cwords, cstate, bits=cbits, with_output=wo,
                chunks=k), reps=5, inner=20 if div else 1)
            _p, _e, r = cdw.fused_decode_words_chunked(
                cprof, cwords, cstate, bits=cbits, with_output=wo, chunks=k)
            sweep[(k, wo)] = (t, int(r.item()))
            phase(5, "time_words_corpus_batch_chunks", gpu=repr(gpu),
                  shape=f"B={Bs},L={Lc},bits={cbits}", K=k,
                  Bc=cdw.word_chunks(Bs, k)[1], with_output=wo,
                  kernel_ms=f"{t:.6f}", rounds=int(r.item()),
                  picked=k == K)
    corpus_batch = {"shape": f"B={Bs},L={Lc},bits={cbits}", "ms": kw,
                    "K": K, "rounds": rounds_p, "bound_ms": b_ms,
                    "bound_by": b_by, "serial_ms": sweep[(1, True)][0]}

    # one packed host->device copy against three of the same bytes
    parts = (buf[:nw], buf[nw:nw + npr], buf[nw + npr:])
    one = cuda_ms(torch, lambda: buf.to(dev, non_blocking=True), inner=5)
    three = cuda_ms(torch, lambda: [t.to(dev, non_blocking=True)
                                    for t in parts], inner=5)
    phase(5, "time_h2d_packed_vs_three", gpu=repr(gpu),
          mbytes=f"{buf.numel() * 4 / 1e6:.3f}", packed_ms=f"{one:.6f}",
          three_ms=f"{three:.6f}")

    # decode_corpus end to end after a warm pass, median of 3, and the
    # stages it times itself
    samples = n_files * nblocks * 32 * channels
    runs, counted = [], []
    for rep in range(4):
        out = tmp / f"corpus_time_{rep}"
        t0 = time.perf_counter()
        res = decode_corpus(src, out, device=dev, batch_files=batch)
        dt = time.perf_counter() - t0
        if res.converted != n_files:
            raise AssertionError(f"timed corpus run converted {res.converted}")
        shutil.rmtree(out)
        if rep:
            runs.append(dt)
            counted.append(res.counters)
    e2e = statistics.median(runs)
    phase(5, "time_decode_corpus", gpu=repr(gpu), files=n_files,
          seconds=f"{e2e:.6f}", files_per_s=f"{n_files / e2e:.3f}",
          msamples_per_s=f"{samples / e2e / 1e6:.3f}",
          runs=[f"{s:.6f}" for s in runs])
    phase(5, "decode_corpus_stages_ms", gpu=repr(gpu), **stage_split(counted))

    # encode_corpus end to end after a warm pass, median of 3, and the
    # stages it times itself: its route (the batch through the search's
    # fixed point), then the serial search kernel alone on the same batch
    # (BJXA_ENCODE_FIXPOINT_CHUNKS=0, the route before the fixed point)
    en_files, _ch, en_frames = ENCODE_CORPUS
    for route in ("fixpoint", "serial"):
        if route == "serial":
            os.environ["BJXA_ENCODE_FIXPOINT_CHUNKS"] = "0"
        runs, counted = [], []
        try:
            for rep in range(4):
                out = tmp / f"enc_time_{rep}"
                t0 = time.perf_counter()
                res = encode_corpus(enc["src"], out, device=dev)
                dt = time.perf_counter() - t0
                if res.converted != en_files:
                    raise AssertionError(
                        f"timed encode corpus: {res.converted}")
                shutil.rmtree(out)
                if rep:
                    runs.append(dt)
                    counted.append(res.counters)
        finally:
            os.environ.pop("BJXA_ENCODE_FIXPOINT_CHUNKS", None)
        e2e = statistics.median(runs)
        suffix = "" if route == "fixpoint" else "_serial_route"
        phase(5, f"time_encode_corpus{suffix}", gpu=repr(gpu),
              files=en_files, route=route, seconds=f"{e2e:.6f}",
              files_per_s=f"{en_files / e2e:.3f}",
              msamples_per_s=f"{en_files * en_frames * 2 / e2e / 1e6:.3f}",
              runs=[f"{s:.6f}" for s in runs])
        phase(5, f"encode_corpus_stages_ms{suffix}", gpu=repr(gpu),
              route=route, **stage_split(counted),
              phase_seconds=f"{time.perf_counter() - t_phase:.3f}")
    return ms, corpus_batch


def check_measurement_kernels(torch, dev, rng) -> dict:
    """Phase 2 for the measurement kernels: every instantiation of
    ``decode_variants``, ``loadstore_bound`` and ``alu_mix`` against its
    plain version on the card, at the scripts' shape and ragged ones; the
    i16 variants also against the production kernels, the pair form against
    i16 through its int16 view; the variants' chunked schedule
    (``VARIANT_CHUNKED``) against the chunked plain version, rounds
    included, and against the words and lanes kernels.  Returns the max
    |kernel - plain| each."""
    from bjxa_tpu_torch.benchmarks import (_variants, load_variants,
                                           roofline_bound, store_variants)
    from bjxa_tpu_torch.ops import cuda_decode, cuda_decode_words as cdw
    from bjxa_tpu_torch.ops.decode import pack_words_from_lanes
    from bjxa_tpu_torch.tools import encode_pack_falsify as probe

    worst = {"decode_variants": 0, "loadstore_bound": 0, "alu_mix": 0}
    for B, L in VARIANT_SHAPES:
        blocks_t = rng.integers(0, 256, size=(B, 33, L), dtype=np.uint8)
        blocks_t[:, 0, :] = (rng.integers(0, 8, size=(B, L)) << 4
                             | rng.integers(0, 16, size=(B, L))
                             ).astype(np.uint8)
        bt = torch.from_numpy(blocks_t).to(dev)
        st = torch.from_numpy(rng.integers(
            -(2**15), 2**15, size=(L, 2)).astype(np.int32)).to(dev)
        prof, words = pack_words_from_lanes(bt, bits=8)
        ref_w, end_w = cdw.fused_decode_words(prof, words, st, bits=8)
        ref_l, end_l = cuda_decode.fused_decode_lanes(bt, st, bits=8)
        runs = [(f"w32+{store}",
                 load_variants.decode_w32(prof, words, st, store=store),
                 load_variants.decode_w32_plain(prof, words, st, store=store))
                for store in load_variants.STORES]
        runs += [(f"u8+{mode}",
                  store_variants.decode_variant(bt, st, mode=mode),
                  store_variants.decode_variant_plain(bt, st, mode=mode))
                 for mode in store_variants.MODES]
        torch.cuda.synchronize()
        for name, (out, end), (pout, pend) in runs:
            e = max(exact_err(out, pout), exact_err(end, pend))
            if name.endswith("pair"):
                out = _variants.pair_to_i16(out)
            elif name.endswith("i32"):
                out = out.to(torch.int16)
            ref, ref_end = (ref_w, end_w) if name[0] == "w" else (ref_l, end_l)
            e = max(e, exact_err(out, ref), exact_err(end, ref_end))
            worst["decode_variants"] = max(worst["decode_variants"], e)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, L, chunks, offset in VARIANT_CHUNKED:
        blocks_t = rng.integers(0, 256, size=(B, 33, L), dtype=np.uint8)
        blocks_t[:, 0, :] = (rng.integers(0, 8, size=(B, L)) << 4
                             | rng.integers(0, 16, size=(B, L))
                             ).astype(np.uint8)
        flat = torch.empty(blocks_t.size + offset, dtype=torch.uint8,
                           device=dev)
        bt = flat[offset:].view(blocks_t.shape)
        bt.copy_(torch.from_numpy(blocks_t))
        st = torch.from_numpy(rng.integers(
            -(2**15), 2**15, size=(L, 2)).astype(np.int32)).to(dev)
        prof, words = pack_words_from_lanes(bt, bits=8)
        K = chunks if chunks is not None else cdw.pick_word_chunks(B, L, sms)
        K, Bc = cdw.word_chunks(B, K)
        # the plain schedule once: every variant is a repack of it
        ppcm, pend, prounds = cuda_decode.chunked_lanes_plain(
            bt, st, bits=8, chunks=K)
        ref_w, end_w, rounds_w = cdw.fused_decode_words_chunked(
            prof, words, st, bits=8, chunks=chunks)
        ref_l, end_l = (cuda_decode.fused_decode_lanes(bt, st, bits=8) if B
                        else cuda_decode.fused_decode_lanes_plain(
                            bt, st, bits=8))
        runs = [(f"w32+{s}", load_variants.decode_w32_chunked(
                    prof, words, st, store=s, chunks=chunks))
                for s in load_variants.STORES]
        runs += [(f"u8+{m}", store_variants.decode_variant_chunked(
                     bt, st, mode=m, chunks=chunks))
                 for m in store_variants.MODES]
        torch.cuda.synchronize()
        e = max(exact_err(ref_w, ppcm), exact_err(end_w, pend),
                exact_err(ref_l, ppcm), exact_err(end_l, pend))
        rounds = {"words": int(rounds_w.item())}
        for name, (out, end, r) in runs:
            store = name.split("+")[1]
            e = max(e, exact_err(out, _variants.repack(ppcm, store)),
                    exact_err(end, pend))
            rounds[name] = int(r.item())
        if set(rounds.values()) != {prounds}:
            raise AssertionError(f"variants at B={B}, L={L}, K={K}: rounds"
                                 f" {rounds}, the plain version {prounds}")
        worst["decode_variants"] = max(worst["decode_variants"], e)
        phase(2, "variants_chunked_equal_plain", shape=f"B={B},L={L},bits=8",
              K=K, Bc=Bc, forced=chunks is not None, rounds=prounds,
              instantiations=len(runs), items=K * L,
              blocks_offset=bt.data_ptr() % 16)
    for B, L, bits in WORDS_SHAPES:
        prof, words, state = (torch.from_numpy(a).to(dev)
                              for a in words_case(rng, B, L, bits))
        out, end = roofline_bound.null_decode(prof, words, state)
        pout, pend = roofline_bound.null_decode_plain(prof, words, state)
        torch.cuda.synchronize()
        worst["loadstore_bound"] = max(worst["loadstore_bound"],
                                       exact_err(out, pout),
                                       exact_err(end, pend))
    for dtype in (torch.int32, torch.int16):
        info = torch.iinfo(dtype)
        for shape, offset in ALU_SHAPES:
            if offset * dtype.itemsize >= 16:
                continue  # every address modulo 16 is taken by now
            shape = shape or probe.SHAPE
            n = int(np.prod(shape))
            x = torch.from_numpy(rng.integers(
                info.min, info.max + 1, size=n + offset)).to(dtype).to(dev)
            x = x[offset:].view(shape)
            for mix in probe.MIXES:
                got = probe.alu_mix(x, mix=mix)
                want = probe.alu_mix_plain(x, mix=mix)
                torch.cuda.synchronize()
                worst["alu_mix"] = max(worst["alu_mix"], exact_err(got, want))
    return worst


def segmented_cli_checks(tmp: pathlib.Path, whole_wav: bytes,
                         bad_prefix: bytes) -> None:
    """Phase 4 for the segmented decode through the CLI: the 5-minute
    stream in 65,536-block segments gives the whole-file WAV; an invalid
    profile and a truncated body fail on the card as on the CPU, with the
    whole-file path's prefix."""
    t0 = time.perf_counter()
    res = run_cli("decode", "--segment-blocks", SEGMENT_BLOCKS,
                  tmp / "stereo6_5min.xa", tmp / "seg.wav", platform=None)
    if res.returncode != 0 or res.stderr:
        raise AssertionError(f"segmented decode: exit {res.returncode}"
                             f" {res.stderr.decode()[-2000:]}")
    if (tmp / "seg.wav").read_bytes() != whole_wav:
        raise AssertionError("segmented WAV != whole-file WAV")
    phase(4, "cli_segmented_wav_equals_whole_file", stream="stereo6_5min",
          segment_blocks=SEGMENT_BLOCKS, wav_bytes=len(whole_wav),
          seconds=f"{time.perf_counter() - t0:.3f}")

    bad = (tmp / "bad.xa").read_bytes()
    channels, size = BAD_STREAM[1], 4 * BAD_STREAM[0] + 1
    cut_blocks = BAD_STREAM[3][0] * 3 // 4  # before the invalid profile
    (tmp / "cut.xa").write_bytes(bad[:32 + cut_blocks * channels * size + 17])
    want_cut = bad_prefix[:44 + cut_blocks * 32 * channels * 2]
    for name, label, want in (
        ("bad", b"bjxa_decode: Protocol error\n", bad_prefix),
        ("cut", b"fread: End of file\n", want_cut),
    ):
        for plat in (None, "cpu"):
            res = run_cli("decode", "--segment-blocks", 4096,
                          tmp / f"{name}.xa", tmp / f"{name}_seg_{plat}.wav",
                          platform=plat)
            if res.returncode != 1 or res.stderr != label:
                raise AssertionError(
                    f"segmented {name} on {plat or 'cuda'}: exit"
                    f" {res.returncode} {res.stderr.decode()[-2000:]}")
            if (tmp / f"{name}_seg_{plat}.wav").read_bytes() != want:
                raise AssertionError(f"segmented {name} on {plat or 'cuda'}:"
                                     " prefix differs from the whole-file"
                                     " path's")
        phase(4, "cli_segmented_failure", case=name, exit=1,
              stderr=repr(label.decode().strip()), prefix_bytes=len(want),
              equals_cpu=True)


def big_file_segmented() -> dict:
    """Phase 4: one file above the 256 MB threshold through ``decode`` with
    no flag (the automatic segmented route) and, with the threshold raised,
    through the whole-file path, each in its own process: the same WAV, and
    a smaller peak RSS segmented."""
    from bjxa_tpu_torch.benchmarks.segmented import write_big_xa

    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_big_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        fmt = write_big_xa(tmp / "big.xa", BIG_BLOCKS, seed=SEED)
        gen_s = time.perf_counter() - t0
        runs = {}
        for name, env in (("segmented", {}),
                          ("whole_file", {"BJXA_SEGMENT_THRESHOLD": 1 << 40})):
            t0 = time.perf_counter()
            code, err, rss = run_cli_rss("decode", tmp / "big.xa",
                                         tmp / f"{name}.wav", **env)
            if code != 0 or err:
                raise AssertionError(f"big file, {name}: exit {code} {err}")
            runs[name] = {"sha1": file_sha1(tmp / f"{name}.wav"),
                          "rss_mb": rss, "s": time.perf_counter() - t0,
                          "bytes": (tmp / f"{name}.wav").stat().st_size}
            (tmp / f"{name}.wav").unlink()
    seg, whole = runs["segmented"], runs["whole_file"]
    if seg["sha1"] != whole["sha1"] or seg["bytes"] != 44 + fmt.data_len_pcm:
        raise AssertionError(f"big file: segmented {seg} vs whole {whole}")
    if seg["rss_mb"] >= whole["rss_mb"]:
        raise AssertionError(f"big file: segmented peak RSS {seg['rss_mb']}"
                             f" MB is not below {whole['rss_mb']} MB")
    phase(4, "cli_big_file_auto_segmented", blocks=BIG_BLOCKS,
          xa_mb=f"{fmt.data_len / 1e6:.1f}",
          pcm_mb=f"{fmt.data_len_pcm / 1e6:.1f}", wav_sha1=seg["sha1"][:12],
          segmented_rss_mb=f"{seg['rss_mb']:.1f}",
          whole_file_rss_mb=f"{whole['rss_mb']:.1f}",
          segmented_s=f"{seg['s']:.3f}", whole_file_s=f"{whole['s']:.3f}",
          gen_s=f"{gen_s:.3f}")
    return runs


def segmented_counted(torch, dev, xa: bytes, whole_wav: bytes, wav: bytes,
                      whole_xa: bytes) -> dict:
    """Phase 4: the stream API in-process with its launches counted: the
    5-minute streams through ``decode_xa_stream`` and ``encode_wav_stream``
    in 65,536-block segments, the CLI's default: one stream-kernel launch a
    decode segment, no launch of the lanes kernel."""
    from bjxa_tpu_torch import decode_xa_stream, encode_wav_stream
    from bjxa_tpu_torch.ops import cuda_decode, cuda_encode

    cuda_decode.LAUNCHES = cuda_decode.STREAM_LAUNCHES = 0
    cuda_encode.LAUNCHES = cuda_encode.FIXPOINT_LAUNCHES = 0
    out = io.BytesIO()
    fmt = decode_xa_stream(io.BytesIO(xa), out, device=dev,
                           segment_blocks=SEGMENT_BLOCKS)
    decode_launches = cuda_decode.STREAM_LAUNCHES
    if out.getvalue() != whole_wav:
        raise AssertionError("decode_xa_stream WAV != whole-file WAV")
    out = io.BytesIO()
    encode_wav_stream(io.BytesIO(wav), out, device=dev,
                      segment_blocks=SEGMENT_BLOCKS)
    encode_launches = cuda_encode.FIXPOINT_LAUNCHES
    if out.getvalue() != whole_xa:
        raise AssertionError("encode_wav_stream XA != whole-file XA")
    segments = -(-fmt.blocks // SEGMENT_BLOCKS)
    # a segment is one launch: the stream kernel, the search's fixed point
    if (decode_launches != segments or cuda_decode.LAUNCHES
            or encode_launches != segments or cuda_encode.LAUNCHES):
        raise AssertionError(
            f"segmented path: {decode_launches} stream-kernel,"
            f" {cuda_decode.LAUNCHES} lanes-kernel, {encode_launches}"
            f" fixed-point and {cuda_encode.LAUNCHES} search launches over"
            f" {segments} segments")
    phase(4, "segmented_main_path_launches", segments=segments,
          decode_stream=decode_launches, decode_lanes=cuda_decode.LAUNCHES,
          encode_fixpoint=encode_launches,
          encode_search=cuda_encode.LAUNCHES)
    return {"decode_stream": decode_launches,
            "encode_fixpoint": encode_launches}


def oversized_corpus_counted(torch, dev, images: dict, wavs: dict) -> int:
    """Phase 4: ``decode_corpus`` in-process over the 5-minute stream, made
    an oversized file by a lowered ``BJXA_SEGMENT_THRESHOLD``, and the
    23-block stream: the CPU's WAVs, one stream-kernel launch a segment of
    the big file, one words-kernel launch for the short file's batch.
    Returns the stream-kernel launches."""
    from bjxa_tpu_torch import decode_corpus, parse_xa_header
    from bjxa_tpu_torch.ops import cuda_decode, cuda_decode_words

    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_over_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "src").mkdir()
        for name, img in images.items():
            (tmp / "src" / f"{name}.xa").write_bytes(img)
        cuda_decode.LAUNCHES = cuda_decode.STREAM_LAUNCHES = 0
        cuda_decode_words.LAUNCHES = 0
        os.environ["BJXA_SEGMENT_THRESHOLD"] = str(1 << 20)
        try:
            run = decode_corpus(tmp / "src", tmp / "out", device=dev)
        finally:
            del os.environ["BJXA_SEGMENT_THRESHOLD"]
        if run.converted != len(images) or run.failed:
            raise AssertionError(f"oversized corpus: {run.converted}"
                                 f" converted, {run.failed}")
        for name, want in wavs.items():
            if (tmp / "out" / f"{name}.wav").read_bytes() != want:
                raise AssertionError(f"oversized corpus {name}: WAV != CPU")
    segments = -(-parse_xa_header(images["big"]).blocks // SEGMENT_BLOCKS)
    launches = cuda_decode.STREAM_LAUNCHES
    if (launches != segments or cuda_decode.LAUNCHES
            or cuda_decode_words.LAUNCHES != 1):
        raise AssertionError(
            f"oversized corpus: {launches} stream-kernel launches over"
            f" {segments} segments, {cuda_decode.LAUNCHES} lanes-kernel and"
            f" {cuda_decode_words.LAUNCHES} words-kernel launches")
    phase(4, "corpus_oversized_launches", files=len(images),
          segments=segments, decode_stream=launches,
          decode_words=cuda_decode_words.LAUNCHES,
          decode_lanes=cuda_decode.LAUNCHES,
          segmented_ms=f"{run.counters.stage_ms['segmented']:.3f}",
          equals_cpu=True)
    return launches


def sm_clock_mhz() -> float:
    """The card's SM clock now, in MHz, as nvidia-smi reports it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(res.stdout.strip().splitlines()[0])


def old_short_route(blocks, state, *, bits):
    """``decode_arrays`` as the card ran it before the fused kernel:
    ``inflate_blocks`` and ``decode_lanes`` (about 20 eager kernels around
    one launch of the samples entry) on the blocks' device."""
    from bjxa_tpu_torch.ops.filter import decode_lanes
    from bjxa_tpu_torch.ops.inflate import inflate_blocks

    profiles, samples = inflate_blocks(blocks, bits)
    pcm, end, valid = decode_lanes(profiles.transpose(0, 1),
                                   samples.permute(1, 2, 0), state)
    return pcm.reshape(-1, pcm.shape[-1]), end, valid


def short_timings(torch, dev, gpu: str, short: bytes, short_wav: bytes
                  ) -> dict:
    """Phase 5 for the short-stream path.  CUDA events over windows of
    launches, eager (host and device: what a caller pays a launch) and
    captured in a CUDA graph (the device alone): the launch floor (an
    empty kernel), kernels 3-4 (the samples entry) at B=64, L=2, the fused
    kernel at ``SHORT_TIMED`` and its Bc sweep; the SM clock, the step's
    cycles (the slope of K = 1 between 15 and 61 blocks) and each timing's
    chain floor; the short ``xa_to_wav`` on the fused route and the old one
    (host clock, synchronised, median of 21) with the device kernels of one
    decode on each.  Returns what the kernel summary needs."""
    from bjxa_tpu_torch import xa_to_wav
    from bjxa_tpu_torch.benchmarks.short_stream import device_ops, graph_ms
    from bjxa_tpu_torch.ops import cuda_filter as cf
    from bjxa_tpu_torch.ops import decode as tdecode
    from bjxa_tpu_torch.ops.chunking import pick_short_chunks, word_chunks
    from bjxa_tpu_torch.ops.filter import profile_gains

    rng = np.random.default_rng(SEED + 19)
    out = {}
    floor = {"eager": cuda_ms(torch, lambda: cf.empty_launch(dev), inner=20),
             "graph": graph_ms(lambda: cf.empty_launch(dev))}
    phase(5, "time_launch_floor", gpu=repr(gpu), kernel="empty",
          eager_ms=f"{floor['eager']:.6f}", graph_ms=f"{floor['graph']:.6f}")

    # kernels 3-4: the samples entry at B=64, L=2 (its one-CTA regime)
    samples = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(64, 32, 2)).astype(np.int16)
    ).to(dev)
    k0, k1, shift, _ = (t.contiguous() for t in profile_gains(
        torch.from_numpy(rng.integers(0, 128, size=(64, 2)).astype(np.int32)
                         ).to(dev)))
    st2 = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(2, 2)).astype(np.int32)).to(dev)
    for wo in (True, False):
        def call(wo=wo):
            return cf.adpcm_filter_kernel(samples, k0, k1, shift, st2,
                                          with_output=wo)
        e_ms = cuda_ms(torch, call, inner=20)
        g_ms = graph_ms(call)
        p_ms = cuda_ms(torch, lambda: cf.adpcm_filter_plain(
            samples, k0, k1, shift, st2, with_output=wo), reps=3)
        out[("filter_lanes", wo)] = {"eager_ms": e_ms, "ms": g_ms,
                                     "plain_ms": p_ms}
        phase(5, "time_filter_lanes", gpu=repr(gpu), shape="B=64,L=2",
              with_output=wo,
              eager_ms=f"{e_ms:.6f}", graph_ms=f"{g_ms:.6f}",
              plain_ms=f"{p_ms:.6f}", launch_floor_graph_ms=f"{floor['graph']:.6f}")

    # the fused kernel: the default chunks and the Bc sweep, 8-bit
    fused, sweep = {}, {}
    for B, C in SHORT_TIMED:
        blocks, state = short_case(rng, B, C, 8)
        bd, sd = torch.from_numpy(blocks).to(dev), torch.from_numpy(
            state).to(dev)
        K, Bc = pick_short_chunks(B)
        for wo in (True, False):
            def call(wo=wo, bd=bd, sd=sd):
                return cf.fused_decode_short(bd, sd, bits=8, with_output=wo)
            rounds = int(call()[3].item())
            fused[(B, C, wo)] = {
                "K": K, "Bc": Bc, "rounds": rounds,
                "eager_ms": cuda_ms(torch, call, inner=20),
                "ms": graph_ms(call)}
        for bc in SHORT_BC_SWEEP:
            chunks = -(-B // (B if bc == "B" else bc))
            sK, sBc = word_chunks(B, chunks)
            for wo in (True, False):
                def call(wo=wo, bd=bd, sd=sd, chunks=chunks):
                    return cf.fused_decode_short(bd, sd, bits=8, chunks=chunks,
                                                 with_output=wo)
                sweep[(B, C, bc, wo)] = {
                    "K": sK, "Bc": sBc, "rounds": int(call()[3].item()),
                    "ms": graph_ms(call)}
        if (B, C) == (23, 2):  # the main path's shape: the plain version
            out["plain_ms"] = cuda_ms(torch, lambda: cf.decode_short_plain(
                bd, sd, bits=8), reps=3)
    clock = sm_clock_mhz()
    # the step's cycles: K = 1 at 61 blocks against 15 (stereo, output)
    slope = ((sweep[(61, 2, "B", True)]["ms"] - sweep[(15, 2, "B", True)]["ms"])
             / ((61 - 15) * 32))
    step_cycles = slope * 1e-3 * clock * 1e6

    def chain_floor(r):
        passes = r["rounds"] + 1 if r["K"] > 1 else 1
        return passes * r["Bc"] * 32 * step_cycles / (clock * 1e3)

    for (B, C, wo), r in fused.items():
        r["chain_floor_ms"] = chain_floor(r)
        phase(5, "time_decode_short", gpu=repr(gpu),
              shape=f"B={B},C={C},bits=8", with_output=wo, K=r["K"],
              Bc=r["Bc"], rounds=r["rounds"], eager_ms=f"{r['eager_ms']:.6f}",
              graph_ms=f"{r['ms']:.6f}",
              chain_floor_ms=f"{r['chain_floor_ms']:.6f}",
              launch_floor_graph_ms=f"{floor['graph']:.6f}")
    for (B, C, bc, wo), r in sweep.items():
        r["chain_floor_ms"] = chain_floor(r)
        phase(5, "time_decode_short_bc", gpu=repr(gpu),
              shape=f"B={B},C={C},bits=8", asked_bc=bc, with_output=wo,
              K=r["K"], Bc=r["Bc"], rounds=r["rounds"],
              graph_ms=f"{r['ms']:.6f}",
              chain_floor_ms=f"{r['chain_floor_ms']:.6f}")
    phase(5, "short_chain_model", gpu=repr(gpu), sm_clock_mhz=clock,
          ms_per_step=f"{slope:.9f}", step_cycles=f"{step_cycles:.2f}",
          launch_floor_eager_ms=f"{floor['eager']:.6f}",
          launch_floor_graph_ms=f"{floor['graph']:.6f}")

    # the short xa_to_wav end to end on both routes, and what each launches
    def decode_new():
        return xa_to_wav(short, device=dev)

    def decode_old():
        saved = tdecode.decode_arrays
        tdecode.decode_arrays = old_short_route
        try:
            return xa_to_wav(short, device=dev)
        finally:
            tdecode.decode_arrays = saved

    routes = {}
    for name, fn in (("fused", decode_new), ("old", decode_old),
                     ("old", decode_old), ("fused", decode_new)):
        cf.LAUNCHES = cf.SHORT_LAUNCHES = 0
        if fn() != short_wav:
            raise AssertionError(f"short decode, {name} route: WAV != CPU")
        counts = {"decode_short": cf.SHORT_LAUNCHES,
                  "filter_lanes": cf.LAUNCHES}
        want = {"decode_short": int(name == "fused"),
                "filter_lanes": int(name == "old")}
        if dev.type == "cuda" and counts != want:
            raise AssertionError(f"short decode, {name} route: launched"
                                 f" {counts}, want {want}")
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        routes.setdefault(name, {"launches": counts, "ms": []})
        routes[name]["ms"].append(statistics.median(times))
    for name, fn in (("fused", decode_new), ("old", decode_old)):
        routes[name]["device"] = device_ops(fn)
        phase(5, "time_short_xa_to_wav", gpu=repr(gpu), route=name,
              stream="stereo8_23blocks", launches=routes[name]["launches"],
              median_ms=[f"{m:.4f}" for m in routes[name]["ms"]],
              device_ops=routes[name]["device"])
    out.update(floor=floor, fused=fused, sweep=sweep, clock_mhz=clock,
               step_cycles=step_cycles, routes=routes)
    return out


def stream_timings(torch, dev, gpu: str, payload, state, fmt) -> dict:
    """Phase 5 for the stream kernel at the 5-minute stream: with output
    and states only, against its chunked plain version and its byte bound,
    then a sweep of chunk sizes, each with its round count.
    Returns what the summary needs."""
    from bjxa_tpu_torch.benchmarks.roofline_bound import words_traffic
    from bjxa_tpu_torch.ops import cuda_decode as cd

    B, C, bits = fmt.blocks, fmt.channels, fmt.bits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K, Bc = cd.pick_stream_chunks(B, C, sms)

    def run(wo=True, chunks=None):
        return cd.fused_decode_stream(payload, state, bits=bits, channels=C,
                                      with_output=wo, chunks=chunks)

    rounds = int(run()[2].item())
    ms = {name: cuda_ms(torch, lambda: run(**kw), inner=20)
          for name, kw in (("output", {}), ("states_only", {"wo": False}))}
    plain = cuda_ms(torch, lambda: cd.fused_decode_stream_chunked_plain(
        payload, state, bits=bits, channels=C, chunks=K), reps=3)
    moved = words_traffic(B, C, bits)
    b_ms, b_by = bound(moved, B * 32 * C * DECODE_OPS_PER_SAMPLE)
    phase(5, "time_decode_stream", gpu=repr(gpu),
          shape=f"B={B},C={C},bits={bits}", K=K, Bc=Bc, rounds=rounds,
          kernel_ms=f"{ms['output']:.6f}",
          states_only_ms=f"{ms['states_only']:.6f}",
          plain_ms=f"{plain:.6f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
          share_of_bound=f"{b_ms / ms['output']:.4f}")
    sweep = {}
    for want in sorted(set(STREAM_BC_SWEEP + (Bc,))):
        chunks = -(-B // want)
        k, bc = cd.word_chunks(B, chunks)
        r = int(run(chunks=chunks)[2].item())
        t = cuda_ms(torch, lambda: run(chunks=chunks), inner=20)
        ts = cuda_ms(torch, lambda: run(wo=False, chunks=chunks), inner=20)
        sweep[bc] = {"K": k, "rounds": r, "ms": t, "states_only_ms": ts}
        phase(5, "time_decode_stream_chunks", gpu=repr(gpu), K=k, Bc=bc,
              rounds=r, kernel_ms=f"{t:.6f}", states_only_ms=f"{ts:.6f}",
              default=bc == Bc)
    return {"ms": ms["output"], "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "states_only_ms": ms["states_only"],
            "rounds": rounds, "K": K, "Bc": Bc,
            "bytes": moved, "bc_sweep": sweep}


def measurement_main_path(torch) -> dict:
    """Phase 4 for the measurement path: every script's entry point
    in-process at its full default shape, with every kernel's launches
    counted from zero.  Returns the counts."""
    from bjxa_tpu_torch import bench
    from bjxa_tpu_torch.benchmarks import (ablate, load_variants,
                                           roofline_bound, store_variants)
    from bjxa_tpu_torch.ops import (cuda_decode, cuda_decode_words,
                                    cuda_encode)
    from bjxa_tpu_torch.tools import encode_pack_falsify as probe

    counted = {"decode_lanes": cuda_decode, "decode_words": cuda_decode_words,
               "encode_search": cuda_encode, "loadstore_bound": roofline_bound,
               "load_variants": load_variants,
               "store_variants": store_variants, "alu_mix": probe}
    for mod in counted.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    os.environ["BENCH_REPS"] = "3"
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            if bench.main() != 0:
                raise AssertionError("bench.main() failed")
            for run in (roofline_bound.main, load_variants.main,
                        store_variants.main, ablate.main,
                        probe.bench_int16_vs_int32):
                run()
    finally:
        del os.environ["BENCH_REPS"]
    records = [json.loads(line) for line in text.getvalue().splitlines()]
    metrics = [r["metric"] for r in records]
    if metrics[:3] != ["encode_search_throughput", "corpus_decode_files_per_s",
                       "decode_throughput"]:
        raise AssertionError(f"bench.main() printed {metrics[:3]}")
    launches = {name: mod.LAUNCHES for name, mod in counted.items()}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the measurement path never ran:"
                             f" {launches}")
    phase(4, "measurement_main_path_launches", lines=len(records),
          **launches, seconds=f"{time.perf_counter() - t0:.3f}")
    return launches


def measurement_timings(torch, dev, gpu: str) -> dict:
    """Phase 5 for the measurement kernels: every instantiation against its
    plain version and its bound at the scripts' shapes, the load/store
    bound at 4, 6 and 8 bits and the words kernel on the variants' bytes,
    the variants and the words kernel again on a corpus batch.  Returns,
    per kernel name, what the summary needs."""
    from bjxa_tpu_torch.benchmarks import (load_variants, roofline_bound,
                                           store_variants)
    from bjxa_tpu_torch.ops.decode import pack_words_from_lanes
    from bjxa_tpu_torch.tools import encode_pack_falsify as probe

    rng = np.random.default_rng(SEED + 7)
    B, L = VARIANT_SHAPES[0]
    samples = B * 32 * L
    out = {}

    # the load/store bound against the words decode on the same inputs
    measured = {}
    for bits in (4, 6, 8):
        prof, words, state = (torch.from_numpy(a).to(dev)
                              for a in words_case(rng, B, L, bits))
        k = cuda_ms(torch, lambda: roofline_bound.null_decode(
            prof, words, state), inner=20)
        p = cuda_ms(torch, lambda: roofline_bound.null_decode_plain(
            prof, words, state), reps=3)
        moved = roofline_bound.words_traffic(B, L, bits)
        b_ms, b_by = bound(moved, B * L * (bits + 32))
        measured[bits] = k
        phase(5, "time_loadstore_bound", gpu=repr(gpu),
              shape=f"B={B},L={L},bits={bits}", kernel_ms=f"{k:.6f}",
              plain_ms=f"{p:.6f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
              gb_per_s=f"{moved / k / 1e6:.3f}",
              msamples_per_s=f"{samples / k / 1e3:.1f}")
    out["loadstore_bound"] = {"ms": k, "plain_ms": p, "bound_ms": b_ms,
                              "bound_by": b_by, "measured_ms": measured}

    # the five instantiations of the variants kernel and the words kernel
    # on the same bytes, at the scripts' shape and on a corpus batch
    from bjxa_tpu_torch.ops import cuda_decode_words as cdw

    variants, words_ms = {}, {}
    for label, (vB, vL) in (("scripts", (B, L)), ("corpus_batch",
                                                  VARIANT_CORPUS)):
        blocks_t = rng.integers(0, 256, size=(vB, 33, vL), dtype=np.uint8)
        blocks_t[:, 0, :] = (rng.integers(0, 5, size=(vB, vL)) << 4
                             | rng.integers(0, 16, size=(vB, vL))
                             ).astype(np.uint8)
        bt = torch.from_numpy(blocks_t).to(dev)
        st = torch.zeros((vL, 2), dtype=torch.int32, device=dev)
        prof, words = pack_words_from_lanes(bt, bits=8)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        K = cdw.pick_word_chunks(vB, vL, sms)
        _o, _e, rounds = cdw.fused_decode_words_chunked(prof, words, st,
                                                        bits=8)
        runs = [(f"w32+{s}", lambda s=s: load_variants.decode_w32(
                     prof, words, st, store=s),
                 lambda s=s: load_variants.decode_w32_plain(
                     prof, words, st, store=s)) for s in load_variants.STORES]
        runs += [(f"u8+{m}", lambda m=m: store_variants.decode_variant(
                      bt, st, mode=m),
                  lambda m=m: store_variants.decode_variant_plain(
                      bt, st, mode=m)) for m in store_variants.MODES]
        words_ms[label] = cuda_ms(torch, lambda: cdw.fused_decode_words(
            prof, words, st, bits=8), inner=20)
        vsamples = vB * 32 * vL
        timed = {}
        for name, kernel, plain in runs:
            # the plain versions run B*32 steps: the scripts' shape only
            k = cuda_ms(torch, kernel, inner=20)
            p = cuda_ms(torch, plain, reps=3) if label == "scripts" else None
            written = vsamples * (4 if name.endswith("i32") else 2)
            b_ms, b_by = bound(vB * vL * 33 + written + 2 * vL * 8,
                               vsamples * DECODE_OPS_PER_SAMPLE)
            timed[name] = {"ms": k, "plain_ms": p, "bound_ms": b_ms,
                           "bound_by": b_by}
            phase(5, "time_decode_variant", gpu=repr(gpu), variant=name,
                  shape=f"B={vB},L={vL},bits=8", K=K,
                  rounds=int(rounds.item()), kernel_ms=f"{k:.6f}",
                  plain_ms="not timed" if p is None else f"{p:.6f}",
                  bound_ms=f"{b_ms:.6f}", bound_by=b_by,
                  share_of_bound=f"{b_ms / k:.4f}",
                  over_decode_words=f"{k / words_ms[label]:.4f}",
                  gsamples_per_s=f"{vsamples / k / 1e6:.3f}")
        phase(5, "time_decode_words_beside_variants", gpu=repr(gpu),
              shape=f"B={vB},L={vL},bits=8", K=K, rounds=int(rounds.item()),
              kernel_ms=f"{words_ms[label]:.6f}",
              w32_i16_over_words=(
                  f"{timed['w32+i16']['ms'] / words_ms[label]:.4f}"),
              loadstore_bound_ms=(f"{measured[8]:.6f}" if label == "scripts"
                                  else "not timed"))
        for name, rec in timed.items():
            if label == "scripts":
                variants[name] = rec
            else:
                variants[name][label] = dict(rec, shape=f"B={vB},L={vL}",
                                             K=K, rounds=int(rounds.item()))
    out["decode_variants"] = dict(variants["w32+i16"], instantiations=variants,
                                  decode_words_ms=words_ms)

    # the ALU probe: both element types, every mix, in a CUDA graph (the
    # device alone, the time reported) and eagerly; the bound counts the
    # instructions of each element type's step (probe.step_ops)
    from bjxa_tpu_torch.benchmarks.short_stream import graph_ms

    mixes = {}
    n = probe.SHAPE[0] * probe.SHAPE[1]
    for dtype in (torch.int32, torch.int16):
        x = probe.probe_input(dtype, dev)
        for mix in probe.MIXES:
            def call(x=x, mix=mix):
                return probe.alu_mix(x, mix=mix)
            g = graph_ms(call)
            k = cuda_ms(torch, call, inner=20)
            p = cuda_ms(torch, lambda: probe.alu_mix_plain(x, mix=mix),
                        reps=3)
            ops = n * probe.STEPS * probe.step_ops(x.element_size(), mix)
            b_ms, b_by = bound(2 * n * x.element_size(), ops)
            pipe_ms = ops / INT_PIPE_OPS_PER_S * 1e3
            name = f"{str(dtype).removeprefix('torch.')}+{mix}"
            mixes[name] = {"ms": g, "eager_ms": k, "plain_ms": p,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "share_of_bound": b_ms / g,
                           "pipe_bound_ms": pipe_ms}
            phase(5, "time_alu_mix", gpu=repr(gpu), variant=name,
                  shape=f"{probe.SHAPE[0]}x{probe.SHAPE[1]}x{probe.STEPS}",
                  graph_ms=f"{g:.6f}", eager_ms=f"{k:.6f}",
                  plain_ms=f"{p:.6f}", bound_ms=f"{b_ms:.6f}",
                  bound_by=b_by, share_of_bound=f"{b_ms / g:.4f}",
                  pipe_bound_ms=f"{pipe_ms:.6f}",
                  gelem_steps_per_s=f"{n * probe.STEPS / g / 1e6:.1f}")
    ratio = {mix: mixes[f"int32+{mix}"]["ms"] / mixes[f"int16+{mix}"]["ms"]
             for mix in probe.MIXES}
    for mix, r in ratio.items():
        phase(5, "alu_int16_over_int32", gpu=repr(gpu), mix=mix,
              int16_over_int32=f"{r:.4f}", needs="2.0")
    out["alu_mix"] = dict(mixes["int32+full"], instantiations=mixes,
                          int16_over_int32=ratio)
    return out


def bench_children(gpu: str) -> None:
    """Phase 5: ``python -m bjxa_tpu_torch.bench`` and the bound, variant,
    probe and segmented scripts, each in a child process; every JSON line
    they print is echoed, and a nonzero exit is fatal."""
    scripts = (
        (["bjxa_tpu_torch.bench"], {},
         ["encode_search_throughput", "corpus_decode_files_per_s",
          "decode_throughput"]),
        (["bjxa_tpu_torch.benchmarks.roofline_bound"], {},
         ["loadstore_bound"] * 3),
        (["bjxa_tpu_torch.benchmarks.load_variants"], {},
         ["load_variant_rate"] * 4),
        (["bjxa_tpu_torch.benchmarks.store_variants"], {},
         ["store_variant_rate"] * 3),
        (["bjxa_tpu_torch.tools.encode_pack_falsify", "--bench"], {},
         ["alu_mix_rate"] * 6 + ["int16_over_int32_rate"] * 3),
        (["bjxa_tpu_torch.benchmarks.segmented"], {"BENCH_REPS": 1},
         ["segmented_decode_rate"]),
    )
    for argv, env, want in scripts:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                             env=child_env(None, **env), capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{argv[0]}: exit {res.returncode}"
                                 f" {res.stderr[-2000:]}")
        records = [json.loads(line) for line in res.stdout.splitlines()]
        if [r["metric"] for r in records] != want:
            raise AssertionError(f"{argv[0]} printed"
                                 f" {[r['metric'] for r in records]}")
        for r in records:
            if r["device"] != gpu:
                raise AssertionError(f"{argv[0]} ran on {r['device']!r}")
            print(f"phase 5 {argv[0].rsplit('.', 1)[-1]}: {json.dumps(r)}",
                  flush=True)
        if argv[0].endswith("roofline_bound"):
            for r in records:
                phase(5, "decode_words_vs_measured_bound", gpu=repr(gpu),
                      bits=r["bits"], bound_gb_per_s=r["gb_per_s"],
                      bound_msamples_per_s=r["value"],
                      decode_words_ms=r["decode_words_ms"],
                      share_of_bound=r["decode_words_share_of_bound"])
        phase(5, "child_script", module=argv[0], lines=len(records),
              seconds=f"{time.perf_counter() - t0:.3f}")


def build_native() -> None:
    """Phase 1 for the host code: the native host library, the C ABI
    library and the C CLI from ``bjxa_tpu_torch/native``, with the commands
    that built them; a compiler error raises."""
    from bjxa_tpu_torch import native
    from bjxa_tpu_torch.native import abi

    fresh = not native._SO.exists()
    t0 = time.perf_counter()
    native.build()
    abi.build()
    cli = abi.cli_path()
    if native.lib() is None or abi.lib() is None or cli is None:
        raise AssertionError("the native libraries are off (BJXA_NO_NATIVE)")
    phase(1, "build_native", seconds=f"{time.perf_counter() - t0:.3f}",
          fresh=fresh, host=repr(" ".join(native.compile_command())),
          abi=repr(" ".join(abi.compile_command())),
          cli=repr(" ".join(abi.cli_command())))


def check_wrappers(torch, dev, rng) -> dict:
    """Phase 2 for the channel-major wrappers: ``decode_arrays_fixpoint``
    on the card (the lanes kernel, rounds + 1 launches) against its plain
    version on the CPU at a prime block count for every bits x channels and
    at the 5-minute stream's shape; ``decode_batch`` (one launch of the
    filter kernel) on a corpus batch, against the CPU's plain version over
    its head and the numpy oracle over all of it.  Returns the launches and
    what the summary needs."""
    from bjxa_tpu_torch.ops import cuda_decode, cuda_filter, numpy_ref
    from bjxa_tpu_torch.ops import decode as tdecode

    def blocks_of(bits, channels, B):
        raw = rng.integers(0, 256, size=(channels, B, 4 * bits + 1),
                           dtype=np.uint8)
        raw[..., 0] = (rng.integers(0, 5, size=(channels, B)) << 4
                       | rng.integers(0, 13, size=(channels, B)))
        state = rng.integers(-(2**15), 2**15, size=(channels, 2))
        return torch.from_numpy(raw), torch.from_numpy(state.astype(np.int32))

    t_all = time.perf_counter()
    cases = [(bits, channels, WRAPPER_BLOCKS) for bits in (4, 6, 8)
             for channels in (1, 2)] + [
                 (6, 2, -(-STREAMS["stereo6_5min"][2] // 32))]
    out = {}
    for bits, channels, B in cases:
        b, s = blocks_of(bits, channels, B)
        K = tdecode.pick_chunks(tdecode.pad_bucket(B), channels)
        cuda_decode.LAUNCHES = 0
        card = tdecode.decode_arrays_fixpoint(b.to(dev), s.to(dev), bits=bits,
                                              num_chunks=K)
        torch.cuda.synchronize()
        launches = cuda_decode.LAUNCHES
        t0 = time.perf_counter()
        plain = tdecode.decode_arrays_fixpoint(b, s, bits=bits, num_chunks=K)
        cpu_s = time.perf_counter() - t0
        for c, p in zip(card[:3], plain[:3]):
            exact_err(c.cpu(), p)
        if card[3] != plain[3] or launches != card[3] + 1:
            raise AssertionError(
                f"decode_arrays_fixpoint B={B}: {card[3]} rounds on the card,"
                f" {plain[3]} on the CPU, {launches} lanes-kernel launches")
        out[(bits, channels, B)] = launches
        phase(2, "decode_arrays_fixpoint_equal_plain", bits=bits,
              channels=channels, blocks=B, K=K, rounds=card[3],
              decode_lanes=launches, cpu_plain_s=f"{cpu_s:.3f}")

    files, channels, bits, B = BATCH
    raw = rng.integers(0, 256, size=(files, channels, B, 4 * bits + 1),
                       dtype=np.uint8)
    raw[..., 0] = (rng.integers(0, 5, size=(files, channels, B)) << 4
                   | rng.integers(0, 13, size=(files, channels, B)))
    state = rng.integers(-(2**15), 2**15,
                         size=(files, channels, 2)).astype(np.int32)
    b, s = torch.from_numpy(raw), torch.from_numpy(state)
    cuda_filter.LAUNCHES = 0
    frames, end, valid = tdecode.decode_batch(b.to(dev), s.to(dev),
                                              bits=bits)
    torch.cuda.synchronize()
    batch_launches = cuda_filter.LAUNCHES
    if batch_launches != 1:
        raise AssertionError(f"decode_batch launched the filter kernel"
                             f" {batch_launches} times")
    frames, end, valid = frames.cpu(), end.cpu(), valid.cpu()
    for f in range(files):
        st = state[f].copy()
        want = numpy_ref.decode_lanes_fixpoint(raw[f].transpose(1, 0, 2),
                                               bits, st)
        if not (np.array_equal(frames[f].numpy(), want)
                and np.array_equal(end[f].numpy(), st)):
            raise AssertionError(f"decode_batch file {f} != numpy oracle")
    if not bool(valid.all()):
        raise AssertionError("decode_batch: a valid profile marked invalid")
    head = BATCH_CPU_BLOCKS
    cuda_filter.LAUNCHES = 0
    card = tdecode.decode_batch(b[:, :, :head].to(dev), s.to(dev), bits=bits)
    plain = tdecode.decode_batch(b[:, :, :head], s, bits=bits)
    for c, p in zip(card, plain):
        exact_err(c.cpu(), p)
    exact_err(card[0].cpu(), frames[:, : head * 32])
    phase(2, "decode_batch_equal_plain", files=files, channels=channels,
          bits=bits, blocks=B, cpu_plain_blocks=head,
          filter_lanes=batch_launches, numpy_oracle="match",
          seconds=f"{time.perf_counter() - t_all:.3f}")
    return {"decode_arrays_fixpoint": out[cases[-1]],
            "decode_batch": batch_launches}


def codec_encode_child(wav_path: str, xa_path: str, piece_blocks: str) -> None:
    """Run in a child process under ``BJXA_NO_NATIVE=1``: the streaming
    :class:`~bjxa_tpu_torch.codec.Encoder` search-encodes a WAV file on the
    card, fed ``piece_blocks`` blocks a call; prints its launches of the
    search's fixed point and of the serial search kernel, the calls and
    each call's ms as JSON."""
    from bjxa_tpu_torch import codec, native, parse_riff_header
    from bjxa_tpu_torch.ops import cuda_encode

    if native.available():
        raise AssertionError("the child must run without the native library")
    wav = pathlib.Path(wav_path).read_bytes()
    rf = parse_riff_header(wav)
    cuda_encode.LAUNCHES = cuda_encode.FIXPOINT_LAUNCHES = 0
    xa, call_ms = codec_encode(codec.Encoder(), rf, wav, int(piece_blocks))
    pathlib.Path(xa_path).write_bytes(xa)
    print(json.dumps({"fixpoint_launches": cuda_encode.FIXPOINT_LAUNCHES,
                      "launches": cuda_encode.LAUNCHES,
                      "calls": len(call_ms), "call_ms": call_ms}), flush=True)


def codec_encode(enc, rf, wav: bytes, piece_blocks: int) -> tuple:
    """``enc`` search-encodes the WAVE image ``wav`` (format ``rf``) fed
    ``piece_blocks`` blocks a call; returns the XA image and each call's
    host-clock ms (a call ends with its bytes on the host)."""
    enc.init(rf, 6)
    out, call_ms = [enc.dump_header()], []
    body = memoryview(wav)[44:44 + rf.data_len_pcm]
    step = piece_blocks * 32 * 2 * rf.channels
    for pos in range(0, len(body), step):
        t0 = time.perf_counter()
        out.append(enc.encode(body[pos:pos + step], search=True))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    return b"".join(out), call_ms


def streaming_main_path(images: dict, ref: dict, bad: bytes,
                        bad_wav: bytes, enc: dict) -> dict:
    """Phase 4 for the streaming codec and the C ABI: ``decode
    --streaming`` of the 5-minute file (its WAV equal to the whole-file
    decode's), a cut file and an invalid profile mid-stream (exit code,
    stderr and bytes equal to the whole-file path's CPU run); the streaming
    Encoder in a child process without the native library, on the card
    (one search launch a call), equal to the same Encoder with the native
    library and to ``encode`` of the whole file; ``abi --install``, a C
    client built against it on the saturation vector, and the installed C
    CLI.  ``bad_wav`` is the whole-file CPU run's output of ``bad``.
    Returns the counts and times phase 5 needs."""
    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_codec_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "stereo6_5min.xa").write_bytes(images["stereo6_5min"])
        (tmp / "bad.xa").write_bytes(bad)
        (tmp / "bad_w.wav").write_bytes(bad_wav)
        return _streaming_main_path(tmp, images, ref, enc)


def _streaming_main_path(tmp: pathlib.Path, images: dict, ref: dict,
                         enc: dict) -> dict:
    from bjxa_tpu_torch import codec, native, parse_riff_header
    from bjxa_tpu_torch.format.hexdsl import hex_to_bytes

    # decode --streaming: the 5-minute file, timed over its runs
    runs = []
    for _ in range(STREAMING_RUNS):
        t0 = time.perf_counter()
        res = run_cli("decode", "--streaming", tmp / "stereo6_5min.xa",
                      tmp / "streamed.wav", platform=None)
        runs.append(time.perf_counter() - t0)
        if res.returncode != 0 or res.stderr:
            raise AssertionError(f"decode --streaming: exit {res.returncode}"
                                 f" {res.stderr.decode()[-2000:]}")
        if (tmp / "streamed.wav").read_bytes() != ref["stereo6_5min"]:
            raise AssertionError("decode --streaming WAV != whole-file WAV")
    phase(4, "cli_streaming_equals_whole_file", stream="stereo6_5min",
          runs=len(runs), wav_bytes=len(ref["stereo6_5min"]),
          seconds=f"{sum(runs):.3f}")

    bits, channels, samples, kept = STREAM_CUT
    (tmp / "cut.xa").write_bytes(synth_xa(np.random.default_rng(SEED + 29),
                                          bits, channels, samples)[:kept])
    # the whole-file CPU run of the bad file was made (and its exit code
    # and stderr checked) by phase 4's cli_invalid_profile
    for name, want_err in (("cut", b"fread: End of file\n"),
                           ("bad", b"bjxa_decode: Protocol error\n")):
        t0 = time.perf_counter()
        got = run_cli("decode", "--streaming", tmp / f"{name}.xa",
                      tmp / f"{name}_s.wav", platform=None)
        whole = run_cli("decode", tmp / f"{name}.xa", tmp / f"{name}_w.wav",
                        platform="cpu") if name == "cut" else got
        if (got.returncode, got.stderr) != (1, want_err) or (
            whole.returncode, whole.stderr) != (1, want_err):
            raise AssertionError(
                f"{name}: streaming exit {got.returncode} {got.stderr!r},"
                f" whole-file exit {whole.returncode} {whole.stderr!r}")
        if ((tmp / f"{name}_s.wav").read_bytes()
                != (tmp / f"{name}_w.wav").read_bytes()):
            raise AssertionError(f"{name}: streaming bytes != whole-file")
        phase(4, "cli_streaming_error_equals_whole_file", file=name, exit=1,
              stderr=repr(want_err.decode().strip()),
              wav_bytes=(tmp / f"{name}_s.wav").stat().st_size,
              seconds=f"{time.perf_counter() - t0:.3f}")

    # the streaming Encoder: native in this process, the card in a child
    t0 = time.perf_counter()
    wav = enc["big"]
    (tmp / "big.wav").write_bytes(wav)
    rf = parse_riff_header(wav)
    if not native.available():
        raise AssertionError("the native library is off")
    native_xa, native_ms = codec_encode(codec.Encoder(), rf, wav,
                                        CODEC_PIECE_BLOCKS)
    # the card's Encoder in a child, through the fixed point (every call
    # has 64 blocks or more), and again on the serial search kernel alone
    children = {}
    for route, extra in (("fixpoint", {}),
                         ("serial", {"BJXA_ENCODE_FIXPOINT_CHUNKS": 0})):
        res = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke;"
             " chip_smoke.codec_encode_child(*sys.argv[1:])",
             str(tmp / "big.wav"), str(tmp / f"codec_{route}.xa"),
             str(CODEC_PIECE_BLOCKS)],
            cwd=ROOT, env=child_env(None, BJXA_NO_NATIVE=1, **extra),
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"codec child ({route}): exit"
                                 f" {res.returncode} {res.stderr[-2000:]}")
        child = children[route] = json.loads(res.stdout.splitlines()[-1])
        want = ((child["calls"], 0) if route == "fixpoint"
                else (0, child["calls"]))
        if ((child["fixpoint_launches"], child["launches"]) != want
                or child["calls"] != len(native_ms)):
            raise AssertionError(f"codec child ({route}): {child}")
        card_xa = (tmp / f"codec_{route}.xa").read_bytes()
        if card_xa != native_xa or card_xa != enc["ref"]:
            raise AssertionError(f"streaming Encoder XA ({route}): card =="
                                 f" native {card_xa == native_xa}, native =="
                                 f" encode {native_xa == enc['ref']}")
    child = children["fixpoint"]
    phase(4, "codec_encoder_card_equals_native_and_encode",
          stream="stereo6_5min", piece_blocks=CODEC_PIECE_BLOCKS,
          calls=child["calls"], encode_fixpoint=child["fixpoint_launches"],
          serial_route_encode_search=children["serial"]["launches"],
          xa_bytes=len(card_xa), sha1=sha1(card_xa)[:12],
          seconds=f"{time.perf_counter() - t0:.3f}")

    # abi --install, a C client through pkg-config, the installed C CLI
    t0 = time.perf_counter()
    prefix = tmp / "prefix"
    res = run_cli("abi", "--install", prefix, platform=None)
    roles = [line.split()[0] for line in res.stdout.decode().splitlines()]
    if res.returncode != 0 or res.stderr or roles != [
            "lib", "header", "pkgconfig", "bin"]:
        raise AssertionError(f"abi --install: exit {res.returncode}"
                             f" {res.stdout!r} {res.stderr.decode()[-2000:]}")
    client = tmp / "client.c"
    client.write_text(C_CLIENT)
    pc_env = dict(os.environ, PKG_CONFIG_PATH=str(prefix / "lib/pkgconfig"))
    pkg = subprocess.run(["pkg-config", "--cflags", "--libs", "bjxa"],
                         env=pc_env, capture_output=True, text=True) \
        if shutil.which("pkg-config") else None
    flags = (pkg.stdout.split() if pkg is not None and pkg.returncode == 0
             else [f"-I{prefix}/include", f"-L{prefix}/lib", "-lbjxa"])
    cc = subprocess.run([os.environ.get("CC", "cc"), "-O2", str(client),
                         *flags, "-o", str(tmp / "client")],
                        capture_output=True, text=True)
    if cc.returncode != 0:
        raise AssertionError(f"C client: {cc.stderr[-2000:]}")
    run_env = dict(os.environ, LD_LIBRARY_PATH=str(prefix / "lib"))
    sat = hex_to_bytes(SATURATION_XA)
    got = subprocess.run([str(tmp / "client")], input=sat, env=run_env,
                         capture_output=True, timeout=60)
    if got.returncode != 0 or sha1(got.stdout) != SATURATION_WAV_SHA1:
        raise AssertionError(f"C client: exit {got.returncode}"
                             f" {got.stderr[-2000:]!r}")
    cli = [str(prefix / "bin" / "bjxa"), "decode"]
    sat_cli = subprocess.run(cli, input=sat, capture_output=True, timeout=60)
    big_cli = subprocess.run([*cli, str(tmp / "stereo6_5min.xa"),
                              str(tmp / "c_cli.wav")], capture_output=True,
                             timeout=120)
    if (sat_cli.returncode, big_cli.returncode) != (0, 0) or sha1(
            sat_cli.stdout) != SATURATION_WAV_SHA1 or (
            tmp / "c_cli.wav").read_bytes() != ref["stereo6_5min"]:
        raise AssertionError(f"installed C CLI: {sat_cli.stderr[-500:]!r}"
                             f" {big_cli.stderr[-500:]!r}")
    phase(4, "abi_install_c_client", pkg_config=pkg is not None,
          flags=repr(" ".join(flags)), saturation_sha1="match",
          c_cli_saturation="match", c_cli_5min_wav="match",
          seconds=f"{time.perf_counter() - t0:.3f}")
    return {"streaming_s": runs, "native_ms": native_ms,
            "card_ms": child["call_ms"],
            "serial_card_ms": children["serial"]["call_ms"],
            "launches": child["fixpoint_launches"],
            "calls": child["calls"], "samples": rf.samples * rf.channels}


#: The C client of phase 4: checks the API on a hand-made header, then
#: decodes the XA file on stdin to a WAV on stdout through the installed
#: library.
C_CLIENT = r"""
#include <assert.h>
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <bjxa.h>

int main(void) {
    uint8_t hdr[32] = "KWD1";
    hdr[4] = 25; hdr[8] = 32; hdr[12] = 0x28; hdr[13] = 0x23;
    hdr[14] = 6; hdr[15] = 1;
    bjxa_decoder_t *dec = bjxa_decoder();
    bjxa_format_t fmt;
    uint8_t block[25] = {0};
    int16_t one[32];
    assert(bjxa_parse_header(dec, hdr, sizeof hdr) == 32);
    assert(bjxa_decode(dec, one, sizeof one, block, sizeof block) == 1);
    assert(bjxa_decode(dec, one, sizeof one, block, sizeof block) == -1);
    assert(errno == EPROTO);
    assert(strcmp(bjxa_tpu_version(), "0.5.0") == 0);

    static uint8_t xa[1 << 20];
    size_t n = fread(xa, 1, sizeof xa, stdin);
    if (bjxa_parse_header(dec, xa, n) != 32) return 2;
    if (bjxa_decode_format(dec, &fmt) != 0) return 3;
    uint8_t riff[44];
    if (bjxa_dump_riff_header(dec, riff, sizeof riff) != 44) return 4;
    int16_t *pcm = malloc(fmt.blocks * fmt.block_size_pcm);
    if (bjxa_decode(dec, pcm, fmt.blocks * fmt.block_size_pcm, xa + 32,
                    n - 32) != (int)fmt.blocks) return 5;
    fwrite(riff, 1, sizeof riff, stdout);
    if (bjxa_fwrite_pcm(pcm, fmt.data_len_pcm, stdout) != 0) return 6;
    free(pcm);
    return bjxa_free_decoder(&dec);
}
"""


def streaming_timings(torch, dev, gpu: str, st: dict) -> dict:
    """Phase 5 for the streaming codec and the C ABI: ``decode
    --streaming`` of the 5-minute file; the streaming Encoder's call on the
    card (through the search's fixed point, and on the serial kernel alone)
    against the native host search, each search launch timed alone by CUDA
    events (kernel 7 at L = 2, the fixed point at K = 256), and the plain
    version on the same piece; ``benchmarks/abi.py``.  Returns kernel 7's
    and the plain version's ms at the Encoder's shape."""
    from bjxa_tpu_torch.ops import cuda_encode
    from bjxa_tpu_torch.ops.encode import pick_encode_chunks

    t_all = time.perf_counter()

    s = statistics.median(st["streaming_s"])
    phase(5, "time_decode_streaming", gpu=repr(gpu), stream="stereo6_5min",
          samples=st["samples"], seconds=f"{s:.6f}",
          msamples_per_s=f"{st['samples'] / s / 1e6:.3f}",
          runs=[f"{r:.6f}" for r in st["streaming_s"]])
    # every call but the last (a partial piece)
    card = statistics.median(st["card_ms"][:-1])
    serial_card = statistics.median(st["serial_card_ms"][:-1])
    host = statistics.median(st["native_ms"][:-1])
    rng = np.random.default_rng(SEED + 23)
    pcm = torch.from_numpy(rng.integers(
        -20000, 20000, size=(CODEC_PIECE_BLOCKS, 32, 2)).astype(np.int16)
    ).to(dev)
    state = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    k_ms = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes(
        pcm, state, bits=6), reps=5)
    K = pick_encode_chunks(CODEC_PIECE_BLOCKS, 2)
    f_ms = cuda_ms(torch, lambda: cuda_encode.encode_search_fixpoint_lanes(
        pcm, state, bits=6, num_chunks=K), reps=5)
    fix = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                   num_chunks=K)
    # its plain version on the whole of the same input, timed once (a
    # Python loop of ~20 small launches a sample: seconds, not ms)
    got = cuda_encode.encode_search_lanes(pcm, state, bits=6)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cuda_encode.encode_search_lanes_plain(pcm, state, bits=6)
    stop.record()
    stop.synchronize()
    p_ms = start.elapsed_time(stop)
    for g, f, w in zip(got, fix, want):
        exact_err(g.cpu(), w.cpu())
        exact_err(f.cpu(), w.cpu())
    phase(5, "time_codec_encoder_search", gpu=repr(gpu),
          piece_blocks=CODEC_PIECE_BLOCKS, lanes=2, calls=st["calls"],
          card_call_ms=f"{card:.3f}",
          serial_route_call_ms=f"{serial_card:.3f}",
          native_call_ms=f"{host:.3f}",
          card_us_per_block=f"{card * 1e3 / CODEC_PIECE_BLOCKS:.3f}",
          native_us_per_block=f"{host * 1e3 / CODEC_PIECE_BLOCKS:.3f}",
          kernel_ms=f"{k_ms:.6f}",
          kernel_us_per_block=f"{k_ms * 1e3 / CODEC_PIECE_BLOCKS:.4f}",
          fixpoint_ms=f"{f_ms:.6f}", fixpoint_K=K,
          fixpoint_rounds=int(fix[4].item()),
          plain_ms=f"{p_ms:.3f}", plain_check_blocks=CODEC_PIECE_BLOCKS)
    res = subprocess.run(
        [sys.executable, "-m", "bjxa_tpu_torch.benchmarks.abi"], cwd=ROOT,
        env=child_env(None), capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"benchmarks.abi: exit {res.returncode}"
                             f" {res.stderr[-2000:]}")
    rec = json.loads(res.stdout.splitlines()[-1])
    if rec["device"] != gpu or rec["metric"] != "abi_decode":
        raise AssertionError(f"benchmarks.abi printed {rec}")
    print(f"phase 5 abi: {json.dumps(rec)}", flush=True)
    phase(5, "streaming_timings", seconds=f"{time.perf_counter() - t_all:.3f}")
    return {"ms": k_ms, "plain_ms": p_ms}


def zero_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from bjxa_tpu_torch.ops import (cuda_decode, cuda_decode_words,
                                    cuda_encode, cuda_filter)

    for mod in (cuda_decode, cuda_decode_words, cuda_encode, cuda_filter):
        mod.LAUNCHES = 0
    cuda_decode.STREAM_LAUNCHES = cuda_filter.SHORT_LAUNCHES = 0
    cuda_encode.FIXPOINT_LAUNCHES = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from bjxa_tpu_torch.ops import (cuda_decode, cuda_decode_words,
                                    cuda_encode, cuda_filter)

    return {"decode_lanes": cuda_decode.LAUNCHES,
            "decode_stream": cuda_decode.STREAM_LAUNCHES,
            "decode_short": cuda_filter.SHORT_LAUNCHES,
            "filter_lanes": cuda_filter.LAUNCHES,
            "decode_words": cuda_decode_words.LAUNCHES,
            "encode_search": cuda_encode.LAUNCHES,
            "encode_fixpoint": cuda_encode.FIXPOINT_LAUNCHES}


def counted(fn, *want):
    """``fn()`` with every launch count set to 0 just before it, and the
    counts just after: each kernel of ``want`` launched, no other.
    Returns ``(result, host seconds, counts)``."""
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    got = read_launches()
    wrong = {k: v for k, v in got.items() if (v > 0) != (k in want)}
    if wrong:
        raise AssertionError(f"launched {got}, want {want} and nothing else")
    return out, seconds, got


def mesh_of(card, n: int, axis_names=("sp", "_")):
    from bjxa_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([card] * n, dp=n, sp=1, axis_names=axis_names)


def sp_main_path(torch, card, big: bytes, big_wav: bytes, wav: bytes,
                 want_xa: bytes) -> dict:
    """Phase 4 for the sequence-parallel ring: the 5-minute stream decoded
    by ``decode_file_sharded`` on each mesh of ``SP_MESHES`` (the lanes
    kernel states-only in every round, with output in the final pass) and
    by ``decode_bytes(mesh=)``, each PCM ``xa_to_wav``'s; the ring's rounds
    on a cut equal to the CPU's; the 5-minute WAV search-encoded by
    ``encode_file_sharded`` (kernel 7 in every round), its bytes
    ``wav_to_xa``'s.  Returns what phase 5 and the summary need."""
    from bjxa_tpu_torch import load_pcm, parse_riff_header, parse_xa_header
    from bjxa_tpu_torch.ops.decode import blocks_from_bytes, decode_bytes
    from bjxa_tpu_torch.parallel.sharded import (decode_file_sharded,
                                                 encode_file_sharded)

    fmt = parse_xa_header(big)
    blocks = blocks_from_bytes(memoryview(big)[32:], fmt)
    state = fmt.initial_state_array()
    out = {"decode": {}, "blocks": blocks, "state": state, "fmt": fmt}
    for n in SP_MESHES:
        mesh = mesh_of(card, n)
        (pcm, valid, rounds), secs, got = counted(
            lambda: decode_file_sharded(blocks, state, bits=fmt.bits,
                                        mesh=mesh), "decode_lanes")
        if pcm[: fmt.samples].tobytes() != big_wav[44:] or not valid.all():
            raise AssertionError(f"sp decode on {n} entries != xa_to_wav")
        Bp = -(-fmt.blocks // (16 * n)) * 16 * n
        out["decode"][n] = {"rounds": rounds, "launches": got["decode_lanes"],
                            "mesh": mesh}
        phase(4, "sp_decode_equals_xa_to_wav", entries=n, blocks=fmt.blocks,
              K=16, Bc=Bp // (16 * n), rounds=rounds,
              decode_lanes=got["decode_lanes"], seconds=f"{secs:.3f}")

    # the rounds (and PCM) of the same ring on the CPU, on a cut
    n = max(SP_MESHES)
    cut = np.ascontiguousarray(blocks[:, :SP_CUT_BLOCKS])
    t0 = time.perf_counter()
    card_cut = decode_file_sharded(cut, state, bits=fmt.bits,
                                   mesh=mesh_of(card, n))
    cpu_cut = decode_file_sharded(cut, state, bits=fmt.bits,
                                  mesh=mesh_of(torch.device("cpu"), n))
    if (card_cut[2] != cpu_cut[2] or not np.array_equal(card_cut[0],
                                                        cpu_cut[0])
            or not np.array_equal(card_cut[1], cpu_cut[1])):
        raise AssertionError(f"sp decode cut: card {card_cut[2]} rounds,"
                             f" CPU {cpu_cut[2]}, PCM equal"
                             f" {np.array_equal(card_cut[0], cpu_cut[0])}")
    phase(4, "sp_decode_cut_equals_cpu", entries=n, blocks=SP_CUT_BLOCKS,
          rounds_card=card_cut[2], rounds_cpu=cpu_cut[2],
          seconds=f"{time.perf_counter() - t0:.3f}")

    # the user's entry: decode_bytes with an sp mesh
    pcm, secs, got = counted(
        lambda: decode_bytes(memoryview(big)[32:32 + fmt.data_len], fmt,
                             device=card, mesh=out["decode"][n]["mesh"]),
        "decode_lanes")
    if pcm.tobytes() != big_wav[44:]:
        raise AssertionError("decode_bytes(mesh=) != xa_to_wav")
    out["decode_bytes_launches"] = got["decode_lanes"]
    phase(4, "sp_decode_bytes_mesh", entries=n, decode_lanes=got["decode_lanes"],
          seconds=f"{secs:.3f}")

    # the ring encode of the 5-minute WAV
    rf = parse_riff_header(wav)
    C = rf.channels
    nblocks = -(-rf.samples // 32)
    padded = np.zeros((nblocks * 32, C), np.int16)
    padded[: rf.samples] = load_pcm(wav[44:44 + rf.data_len_pcm], C)
    lanes = padded.reshape(nblocks, 32, C)
    emesh = mesh_of(card, SP_ENCODE_ENTRIES)
    (xa, end, rounds), secs, got = counted(
        lambda: encode_file_sharded(lanes, np.zeros((C, 2), np.int32),
                                    bits=6, mesh=emesh), "encode_search")
    if xa.tobytes() != want_xa[32:]:
        raise AssertionError("sp encode != wav_to_xa")
    grid = 16 * SP_ENCODE_ENTRIES
    out["encode"] = {"lanes": lanes, "mesh": emesh, "rounds": rounds,
                     "launches": got["encode_search"], "first_s": secs}
    phase(4, "sp_encode_equals_wav_to_xa", entries=SP_ENCODE_ENTRIES,
          blocks=nblocks, K=16, Bc=-(-nblocks // grid), rounds=rounds,
          encode_search=got["encode_search"], seconds=f"{secs:.3f}",
          ms_per_launch=f"{secs * 1e3 / got['encode_search']:.3f}",
          note=SERIAL_NOTE)
    return out


def _manifest(d: pathlib.Path) -> list:
    """A corpus run's manifest records: input, output name, samples."""
    recs = []
    for m in sorted(d.glob(".bjxa-*manifest-*.jsonl")):
        for line in m.read_text().splitlines():
            r = json.loads(line)
            recs.append((r["key"], pathlib.Path(r["out"]).name, r["samples"]))
    return sorted(recs)


def dp_main_path(torch, card, corp_src: pathlib.Path,
                 corp_out: pathlib.Path, enc_src: pathlib.Path,
                 enc_out: pathlib.Path, tmp: pathlib.Path) -> dict:
    """Phase 4 for the data-parallel corpus: ``decode_corpus`` and
    ``encode_corpus`` with a mesh of ``DP_ENTRIES`` entries (the words
    kernel, kernel 7, one launch a shard and batch), outputs and manifests
    those of the runs without a mesh.  Returns the launches."""
    from bjxa_tpu_torch import decode_corpus, encode_corpus

    mesh = mesh_of(card, DP_ENTRIES, ("dp", "sp"))
    n_files, _ch, _bits, _nb, batch = CORPUS
    res, secs, got = counted(
        lambda: decode_corpus(corp_src, tmp / "mesh_wav", device=card,
                              batch_files=batch, mesh=mesh), "decode_words")
    batches = -(-n_files // batch)
    if (res.converted != n_files or res.failed
            or got["decode_words"] != batches * DP_ENTRIES):
        raise AssertionError(f"dp decode corpus: {res.converted}"
                             f" {res.failed} {got}")
    for p in corp_out.glob("*.wav"):
        if (tmp / "mesh_wav" / p.name).read_bytes() != p.read_bytes():
            raise AssertionError(f"dp decode corpus {p.name} != no mesh")
    if _manifest(tmp / "mesh_wav") != _manifest(corp_out):
        raise AssertionError("dp decode corpus: manifest != no mesh")
    phase(4, "dp_decode_corpus_equals_no_mesh", entries=DP_ENTRIES,
          files=n_files, batches=batches, decode_words=got["decode_words"],
          seconds=f"{secs:.3f}", note=SERIAL_NOTE)
    out = {"decode_words": got["decode_words"]}
    n_enc = ENCODE_CORPUS[0]
    # each shard's 16 lanes through the search's fixed point
    res, secs, got = counted(
        lambda: encode_corpus(enc_src, tmp / "mesh_xa", device=card,
                              mesh=mesh), "encode_fixpoint")
    if (res.converted != n_enc or res.failed
            or got["encode_fixpoint"] != DP_ENTRIES):
        raise AssertionError(f"dp encode corpus: {res.converted}"
                             f" {res.failed} {got}")
    for p in enc_out.glob("*.xa"):
        if (tmp / "mesh_xa" / p.name).read_bytes() != p.read_bytes():
            raise AssertionError(f"dp encode corpus {p.name} != no mesh")
    if _manifest(tmp / "mesh_xa") != _manifest(enc_out):
        raise AssertionError("dp encode corpus: manifest != no mesh")
    phase(4, "dp_encode_corpus_equals_no_mesh", entries=DP_ENTRIES,
          files=n_enc, encode_fixpoint=got["encode_fixpoint"],
          seconds=f"{secs:.3f}", note=SERIAL_NOTE)
    out["encode_fixpoint"] = got["encode_fixpoint"]
    return dict(out, mesh=mesh)


def transcode_main_path(torch, card, rng) -> dict:
    """Phase 4 for the transcode step over a (dp, cp) mesh of the card:
    the filter kernel's samples entry and kernel 7 on every shard; the
    re-encoded blocks and the MSE of the plain step on the CPU."""
    from bjxa_tpu_torch.parallel.mesh import make_mesh
    from bjxa_tpu_torch.parallel.pipeline import (corpus_shardings,
                                                  transcode_step)

    N, C, B = TRANSCODE
    blocks = rng.integers(0, 256, size=(N, C, B, 25), dtype=np.uint8)
    blocks[..., 0] = (rng.integers(0, 5, size=(N, C, B)) << 4
                      | rng.integers(0, 13, size=(N, C, B)))
    states = rng.integers(-2000, 2000, size=(N, C, 2)).astype(np.int32)
    mesh = make_mesh([card] * 4, dp=2, sp=2, axis_names=("dp", "cp"))
    (xa, mse), secs, got = counted(
        lambda: transcode_step(blocks, states, bits=6,
                               sharding=corpus_shardings(mesh)),
        "filter_lanes", "encode_search")
    t0 = time.perf_counter()
    cpu_xa, cpu_mse = transcode_step(blocks, states, bits=6)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(xa, cpu_xa) or abs(mse - cpu_mse) > 1e-6 * cpu_mse:
        raise AssertionError(f"transcode step: card mse {mse}, CPU {cpu_mse},"
                             f" blocks equal {np.array_equal(xa, cpu_xa)}")
    phase(4, "transcode_step_equals_cpu", mesh="dp=2,cp=2", files=N,
          channels=C, blocks=B, mse=f"{float(mse):.6f}",
          mse_cpu=f"{float(cpu_mse):.6f}", filter_lanes=got["filter_lanes"],
          encode_search=got["encode_search"], seconds=f"{secs:.3f}",
          cpu_plain_s=f"{cpu_s:.3f}")
    return got


def run_children(jobs, timeout: int = 600) -> list:
    """``python -m bjxa_tpu_torch <args>`` for each ``(args, env)`` of
    ``jobs``, all started together; ``[(code, stdout, stderr)]`` in order,
    stderr without torch.distributed's own log lines.  None outlives
    ``timeout``."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bjxa_tpu_torch", *map(str, args)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args, env in jobs]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            se = "".join(line for line in se.splitlines(keepends=True)
                         if "[c10d]" not in line)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def mesh_cli_checks(tmp: pathlib.Path, big: bytes, big_wav: bytes, wav: bytes,
                    want_xa: bytes, corp_src: pathlib.Path,
                    corp_out: pathlib.Path) -> dict:
    """Phase 4 for the CLI's device and process options on a one-card
    host: ``decode``, ``encode`` and ``corpus --devices 1`` give the bytes
    of the runs without it, ``--devices 2`` exits 1 with the JAX package's
    text, and a two-process ``corpus`` (gloo on 127.0.0.1) gives the
    one-process outputs, process 0 the one-process totals.  Returns the
    two-process run's seconds."""
    import socket

    (tmp / "big.xa").write_bytes(big)
    (tmp / "big.wav").write_bytes(wav)
    n_files, _ch, _bits, _nb, batch = CORPUS
    refusal = "--devices 2 out of range (1..1 available)"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = child_env(None)
    jobs = [
        (["decode", "--devices", 1, tmp / "big.xa", tmp / "d1.wav"], env),
        (["encode", "--devices", 1, tmp / "big.wav", tmp / "d1.xa"], env),
        (["corpus", "--devices", 1, "--batch-files", batch, corp_src,
          tmp / "d1_corpus"], env),
        (["decode", "--devices", 2, tmp / "big.xa", tmp / "d2.wav"], env),
        (["encode", "--devices", 2, tmp / "big.wav", tmp / "d2.xa"], env),
        (["corpus", "--devices", 2, corp_src, tmp / "d2_corpus"], env),
    ]
    t0 = time.perf_counter()
    dec1, enc1, cor1, dec2, enc2, cor2 = run_children(jobs)
    if dec1[0] or dec1[2] or (tmp / "d1.wav").read_bytes() != big_wav:
        raise AssertionError(f"decode --devices 1: {dec1[0]} {dec1[2]}")
    if enc1[0] or enc1[2] or (tmp / "d1.xa").read_bytes() != want_xa:
        raise AssertionError(f"encode --devices 1: {enc1[0]} {enc1[2]}")
    summary = f"converted {n_files} skipped 0 failed 0 samples "
    if cor1[0] or cor1[2] or not cor1[1].startswith(summary):
        raise AssertionError(f"corpus --devices 1: {cor1}")
    for p in corp_out.glob("*.wav"):
        if (tmp / "d1_corpus" / p.name).read_bytes() != p.read_bytes():
            raise AssertionError(f"corpus --devices 1: {p.name} differs")
    for name, r in (("decode", dec2), ("encode", enc2)):
        if r != (1, "", f"bjxa: {refusal}\n"):
            raise AssertionError(f"{name} --devices 2: {r}")
    if (cor2[0], cor2[1]) != (1, "") or not cor2[2].startswith(
            f"bjxa: {refusal}\nUsage: "):
        raise AssertionError(f"corpus --devices 2: {cor2}")
    phase(4, "cli_devices", devices_1="bytes of no flag",
          devices_2=repr(f"bjxa: {refusal}"),
          seconds=f"{time.perf_counter() - t0:.3f}")

    t0 = time.perf_counter()
    two = run_children([
        (["corpus", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
          2, "--process-id", i, "--batch-files", batch, corp_src,
          tmp / "mp_corpus"], env) for i in range(2)])
    secs = time.perf_counter() - t0
    if [r[0] for r in two] != [0, 0] or two[0][2] or two[1][2]:
        raise AssertionError(f"two-process corpus: {two}")
    if two[0][1] != cor1[1] or two[1][1] != "":
        raise AssertionError(f"two-process corpus said {two[0][1]!r},"
                             f" {two[1][1]!r}; one process {cor1[1]!r}")
    got = {p.name for p in (tmp / "mp_corpus").glob("*.wav")}
    if got != {p.name for p in corp_out.glob("*.wav")}:
        raise AssertionError("two-process corpus: files differ")
    for p in corp_out.glob("*.wav"):
        if (tmp / "mp_corpus" / p.name).read_bytes() != p.read_bytes():
            raise AssertionError(f"two-process corpus: {p.name} differs")
    phase(4, "cli_corpus_two_processes", processes=2, files=n_files,
          summary=repr(two[0][1].strip()), equals_one_process=True,
          seconds=f"{secs:.3f}")
    return {"two_process_s": secs}


def mesh_timings(torch, card, gpu: str, sp: dict, dp: dict,
                 corp_src: pathlib.Path, enc_src: pathlib.Path,
                 tmp: pathlib.Path) -> dict:
    """Phase 5 for the multi-device layer: the ring decode on each mesh of
    ``SP_MESHES`` and the ring encode (host clock, synchronous), the corpus
    decode and encode with and without a mesh, and the two scaling scripts
    (``benchmarks/multihost.py``, ``benchmarks/mesh_flat.py``) at a small
    size.  Each line says that the shards serialise on one card."""
    from bjxa_tpu_torch import decode_corpus, encode_corpus
    from bjxa_tpu_torch.parallel.sharded import (decode_file_sharded,
                                                 encode_file_sharded)

    fmt, blocks, state = sp["fmt"], sp["blocks"], sp["state"]
    out = {}
    for n, d in sp["decode"].items():
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            _pcm, _v, rounds = decode_file_sharded(blocks, state, bits=fmt.bits,
                                                   mesh=d["mesh"])
            runs.append(time.perf_counter() - t0)
        out[f"sp_decode_{n}_s"] = statistics.median(runs)
        phase(5, "time_sp_decode", gpu=repr(gpu), entries=n,
              blocks=fmt.blocks, rounds=rounds, decode_lanes=d["launches"],
              seconds=f"{statistics.median(runs):.6f}",
              runs=[f"{r:.6f}" for r in runs], note=SERIAL_NOTE)
    e = sp["encode"]
    t0 = time.perf_counter()
    _xa, _end, rounds = encode_file_sharded(
        e["lanes"], np.zeros((e["lanes"].shape[2], 2), np.int32), bits=6,
        mesh=e["mesh"])
    secs = time.perf_counter() - t0
    out["sp_encode_s"] = secs
    phase(5, "time_sp_encode", gpu=repr(gpu), entries=SP_ENCODE_ENTRIES,
          blocks=e["lanes"].shape[0], rounds=rounds,
          encode_search=e["launches"], seconds=f"{secs:.6f}",
          first_run_s=f"{e['first_s']:.6f}",
          ms_per_launch=f"{secs * 1e3 / e['launches']:.3f}", note=SERIAL_NOTE)

    n_files, _ch, _bits, _nb, batch = CORPUS
    for what, fn, src, n in (("decode", decode_corpus, corp_src, n_files),
                             ("encode", encode_corpus, enc_src,
                              ENCODE_CORPUS[0])):
        kw = {"batch_files": batch} if what == "decode" else {}
        secs = {}
        for label, mesh in (("none", None), (f"{DP_ENTRIES}", dp["mesh"])):
            dst = tmp / f"time_{what}_{label}"
            t0 = time.perf_counter()
            res = fn(src, dst, device=card, mesh=mesh, **kw)
            secs[label] = time.perf_counter() - t0
            shutil.rmtree(dst)
            if res.converted != n:
                raise AssertionError(f"timed {what} corpus: {res.failed}")
        out[f"dp_{what}_s"] = secs
        phase(5, f"time_dp_{what}_corpus", gpu=repr(gpu), files=n,
              entries=DP_ENTRIES, seconds=f"{secs[str(DP_ENTRIES)]:.6f}",
              no_mesh_s=f"{secs['none']:.6f}",
              files_per_s=f"{n / secs[str(DP_ENTRIES)]:.3f}",
              no_mesh_files_per_s=f"{n / secs['none']:.3f}",
              note=SERIAL_NOTE)

    for module, env, metric in (
        ("multihost", MULTIHOST_ENV, "multihost_corpus_files_per_s"),
        ("mesh_flat", MESH_FLAT_ENV, "mesh_batch_seconds"),
    ):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"bjxa_tpu_torch.benchmarks.{module}"],
            cwd=ROOT, env=child_env(None, **env), capture_output=True,
            text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{module}: exit {res.returncode}"
                                 f" {res.stderr[-2000:]}")
        (rec,) = [json.loads(line) for line in res.stdout.splitlines()]
        if rec["metric"] != metric or rec["device"] != gpu:
            raise AssertionError(f"{module} printed {rec}")
        out[module] = rec
        print(f"phase 5 {module}: {json.dumps(rec)}", flush=True)
        phase(5, "child_script", module=f"bjxa_tpu_torch.benchmarks.{module}",
              lines=1, seconds=f"{time.perf_counter() - t0:.3f}",
              note=repr("processes and mesh entries share one card"))
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # ---- phase 0: environment ---------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import bjxa_tpu_torch

    pkg = pathlib.Path(bjxa_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"bjxa_tpu_torch imported from {pkg}, not {ROOT}")
    from bjxa_tpu_torch import parse_xa_header, xa_to_wav
    from bjxa_tpu_torch.format.hexdsl import hex_to_bytes
    from bjxa_tpu_torch.ops import _build, cuda_decode, cuda_encode, cuda_filter
    from bjxa_tpu_torch.ops import decode as tdecode

    gpu = gpu_line()
    print(gpu, flush=True)
    dev = torch.device(DEVICE)
    phase(0, "env", gpu=repr(gpu), torch=torch.__version__,
          cuda=torch.version.cuda, devices=torch.cuda.device_count())

    # ---- phase 1: build -----------------------------------------------------
    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log = so.with_suffix(".log").read_text()
    report = ptxas_report(log)
    if set(report) != set(KERNELS):
        raise AssertionError(f"ptxas log names kernels {sorted(report)}")
    phase(1, "build", seconds=f"{time.perf_counter() - t0:.3f}",
          fresh=fresh, library=so.name,
          **{f"{k}_registers": v["registers"] for k, v in report.items()},
          **{f"{k}_spill_bytes": v["spill_bytes"]
             for k, v in report.items()})
    # the search kernel's CTAs per SM as its registers allow them (65,536
    # registers an SM, allocated per thread in steps of 8; at most 2,048
    # threads an SM)
    enc_ptx = report["encode_search"]
    regs = -(-max(enc_ptx["registers"]) // 8) * 8
    phase(1, "encode_search_ptxas", registers=enc_ptx["registers"],
          spill_bytes=enc_ptx["spill_bytes"], cta_threads=ENCODE_CTA_THREADS,
          ctas_per_sm=min(65536 // (regs * ENCODE_CTA_THREADS),
                          2048 // ENCODE_CTA_THREADS))
    # the search's fixed point: the same body, its CTAs an SM as the
    # cooperative launch's occupancy query gives them
    fix_ptx = report["encode_fixpoint"]
    phase(1, "encode_fixpoint_ptxas", registers=fix_ptx["registers"],
          spill_bytes=fix_ptx["spill_bytes"],
          stack_bytes=max(r["stack_bytes"]
                          for r in fix_ptx["instances"].values()),
          cta_threads=ENCODE_CTA_THREADS,
          ctas_per_sm={bits: _build.library().bjxa_encode_fixpoint_occupancy(
              bits, torch.cuda.current_device()) for bits in (4, 6, 8)})
    if fix_ptx["spill_bytes"] or max(fix_ptx["registers"]) > 64:
        raise AssertionError(f"encode_fixpoint spills: {fix_ptx}")

    var_ptx = variants_ptxas(_build.library(), report,
                             torch.cuda.current_device())
    build_native()

    # ---- phase 2: kernels against their plain versions ----------------------
    rng = np.random.default_rng(SEED)
    worst = check_kernels(torch, dev, rng)
    worst["encode_search"] = check_encode_kernel(torch, dev, rng)
    worst["encode_fixpoint"] = check_encode_fixpoint_kernel(
        torch, dev, np.random.default_rng(SEED + 29))
    # its own stream, so the later phases keep the inputs they had before
    # the words kernel was added
    worst["decode_words"] = check_words_kernel(
        torch, dev, np.random.default_rng(SEED + 3))
    worst["decode_stream"] = check_stream_kernel(
        torch, dev, np.random.default_rng(SEED + 13))
    worst["decode_short"] = check_short_kernel(
        torch, dev, np.random.default_rng(SEED + 17))
    worst.update(check_measurement_kernels(
        torch, dev, np.random.default_rng(SEED + 11)))
    wrap = check_wrappers(torch, dev, np.random.default_rng(SEED + 19))
    phase(2, "kernels_equal_plain", **worst)

    # ---- phase 3: known answers ---------------------------------------------
    wav = xa_to_wav(hex_to_bytes(SATURATION_XA), device=dev)
    if sha1(wav) != SATURATION_WAV_SHA1:
        raise AssertionError(f"saturation vector SHA-1 {sha1(wav)}")
    ref_dir = os.environ.get("BJXA_REFERENCE_DIR", "")
    fixtures = pathlib.Path(ref_dir) / "test" if ref_dir else None
    if fixtures is not None and all(
        (fixtures / n).exists() for n in GOLDEN
    ):
        for name, want in GOLDEN.items():
            got = sha1(xa_to_wav((fixtures / name).read_bytes(), device=dev))
            if got != want:
                raise AssertionError(f"{name}: WAV SHA-1 {got} != {want}")
        golden = "6/6 match"
    else:
        golden = "skipped (set BJXA_REFERENCE_DIR to the reference tree)"
    phase(3, "known_answers", saturation_sha1="match", golden=repr(golden))
    encode_known_answers(torch, dev, rng)

    # ---- phase 4: the main path through the CLI -----------------------------
    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        images, ref = {}, {}
        for name, (bits, channels, samples) in STREAMS.items():
            images[name] = synth_xa(rng, bits, channels, samples)
            (tmp / f"{name}.xa").write_bytes(images[name])
            t0 = time.perf_counter()
            ref[name] = xa_to_wav(images[name], device="cpu")
            cpu_s = time.perf_counter() - t0
            res = run_cli("decode", tmp / f"{name}.xa", tmp / f"{name}.wav",
                          platform=None)
            if res.returncode != 0 or res.stderr:
                raise AssertionError(f"{name}: CLI exit {res.returncode}"
                                     f" {res.stderr.decode()[-2000:]}")
            if (tmp / f"{name}.wav").read_bytes() != ref[name]:
                raise AssertionError(f"{name}: card WAV != CPU WAV")
            fmt = parse_xa_header(images[name])
            phase(4, "cli_wav_equals_cpu", stream=name, blocks=fmt.blocks,
                  wav_bytes=len(ref[name]), sha1=sha1(ref[name])[:12],
                  cpu_plain_s=f"{cpu_s:.3f}")

        # an invalid profile mid-stream: exit 1, the reference's label and
        # the same valid prefix on the card as on the CPU
        bits, channels, samples, (bad_block, bad_ch) = BAD_STREAM
        bad = synth_xa(rng, bits, channels, samples, bad=(bad_block, bad_ch))
        (tmp / "bad.xa").write_bytes(bad)
        outs = {}
        for plat in (None, "cpu"):
            res = run_cli("decode", tmp / "bad.xa", tmp / f"bad_{plat}.wav",
                          platform=plat)
            if res.returncode != 1 or res.stderr != (
                b"bjxa_decode: Protocol error\n"
            ):
                raise AssertionError(f"invalid profile on {plat or 'cuda'}:"
                                     f" exit {res.returncode}"
                                     f" {res.stderr.decode()[-2000:]}")
            outs[plat] = (tmp / f"bad_{plat}.wav").read_bytes()
        prefix = 44 + bad_block * 32 * channels * 2
        bad_wav = outs["cpu"]
        if outs[None] != outs["cpu"] or len(outs[None]) != prefix:
            raise AssertionError("invalid-profile prefix differs")
        phase(4, "cli_invalid_profile", exit=1,
              stderr=repr("bjxa_decode: Protocol error"),
              prefix_bytes=len(outs[None]), equals_cpu=True)
        segmented_cli_checks(tmp, ref["stereo6_5min"], outs[None])

    # the lane-major fixed point (decode_fixpoint_lanes, the JAX package's
    # twin) on the card and on the CPU: same rounds, same output
    big = images["stereo6_5min"]
    fmt = parse_xa_header(big)
    Bp = tdecode.pad_bucket(fmt.blocks)
    K = tdecode.pick_chunks(Bp, fmt.channels)
    staged = tdecode.chunk_lanes_from_bytes(big[32:], fmt, K, Bp)
    fix = {}
    cuda_decode.LAUNCHES = 0
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        frames, end, _valid, rounds = tdecode.decode_fixpoint_lanes(
            torch.from_numpy(staged).to(d),
            torch.from_numpy(fmt.initial_state_array()).to(d),
            bits=fmt.bits, num_chunks=K, channels=fmt.channels, b_total=Bp,
        )
        fix[where] = (frames.cpu(), end.cpu(), rounds)
    if not (torch.equal(fix["card"][0], fix["cpu"][0])
            and torch.equal(fix["card"][1], fix["cpu"][1])
            and fix["card"][2] == fix["cpu"][2]):
        raise AssertionError("fixed point differs between card and CPU")
    fixpoint_lanes_launches = cuda_decode.LAUNCHES
    if fixpoint_lanes_launches != fix["card"][2] + 1:
        raise AssertionError(f"decode_fixpoint_lanes launched the lanes kernel"
                             f" {fixpoint_lanes_launches} times, want rounds"
                             f" + 1 = {fix['card'][2] + 1}")
    phase(4, "fixpoint_lanes_card_equals_cpu", K=K, Bc=Bp // K,
          lanes=K * fmt.channels, rounds=fix["card"][2],
          decode_lanes=fixpoint_lanes_launches)

    # the stream kernel at the card's K against its chunked plain version on
    # the CPU: same frames (the CPU's WAV), end state and rounds
    payload_d = torch.frombuffer(bytearray(big[32:32 + fmt.data_len]),
                                 dtype=torch.uint8).to(dev)
    state_d = torch.from_numpy(fmt.initial_state_array()).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sK, sBc = cuda_decode.pick_stream_chunks(fmt.blocks, fmt.channels, sms)
    frames, end, rounds_d = cuda_decode.fused_decode_stream(
        payload_d, state_d, bits=fmt.bits, channels=fmt.channels)
    pframes, pend, rounds = cuda_decode.fused_decode_stream_chunked_plain(
        payload_d.cpu(), state_d.cpu(), bits=fmt.bits, channels=fmt.channels,
        chunks=sK)
    if int(rounds_d.item()) != rounds:
        raise AssertionError(f"stream kernel: {int(rounds_d.item())} rounds,"
                             f" the chunked plain version {rounds}")
    exact_err(frames.cpu(), pframes)
    exact_err(end.cpu(), pend)
    if pframes[: fmt.samples].numpy().tobytes() != ref["stereo6_5min"][44:]:
        raise AssertionError("stream kernel frames != the CPU's WAV")
    phase(4, "stream_card_equals_chunked_plain", K=sK, Bc=sBc,
          items=sK * fmt.channels, rounds=rounds)

    # the main path in-process, counted, each decode from counts set to 0:
    # the long stream is one stream-kernel launch and no launch of the
    # lanes kernel, the short one exactly one launch of the fused
    # short-stream kernel and none of the others
    short = images["stereo8_23blocks"]

    def counted_decode(image):
        for mod in (cuda_decode, cuda_filter, cuda_encode):
            mod.LAUNCHES = 0
        cuda_decode.STREAM_LAUNCHES = cuda_filter.SHORT_LAUNCHES = 0
        wav = xa_to_wav(image, device=dev)
        return wav, {"decode_stream": cuda_decode.STREAM_LAUNCHES,
                     "decode_lanes": cuda_decode.LAUNCHES,
                     "decode_short": cuda_filter.SHORT_LAUNCHES,
                     "filter_lanes": cuda_filter.LAUNCHES,
                     "encode_search": cuda_encode.LAUNCHES}

    got_big, big_counts = counted_decode(big)
    got_short, short_counts = counted_decode(short)
    if got_big != ref["stereo6_5min"] or got_short != ref["stereo8_23blocks"]:
        raise AssertionError("in-process card WAV != CPU WAV")
    if big_counts != dict.fromkeys(big_counts, 0) | {"decode_stream": 1}:
        raise AssertionError(f"the long decode launched {big_counts}, want"
                             " one stream-kernel launch and nothing else")
    if short_counts != dict.fromkeys(short_counts, 0) | {"decode_short": 1}:
        raise AssertionError(f"the short decode launched {short_counts},"
                             " want one fused short-stream launch and"
                             " nothing else")
    launches = {"decode_stream": big_counts["decode_stream"],
                "decode_short": short_counts["decode_short"]}
    phase(4, "main_path_launches", K=sK, Bc=sBc, items=sK * fmt.channels,
          rounds=rounds, long=big_counts, short=short_counts)
    enc = encode_main_path(torch, dev, rng)
    seg_launches = segmented_counted(torch, dev, big, ref["stereo6_5min"],
                                     enc["big"], enc["ref"])
    over_launches = oversized_corpus_counted(
        torch, dev, {"big": big, "short": short},
        {"big": ref["stereo6_5min"], "short": ref["stereo8_23blocks"]})
    big_file_segmented()
    ctmp_dir = tempfile.TemporaryDirectory(prefix="bjxa_smoke_corpus_")
    ctmp = pathlib.Path(ctmp_dir.name)
    corp = corpus_main_path(torch, dev, rng, ctmp)
    enc_corp = encode_corpus_main_path(torch, dev, rng, ctmp)
    worst["encode_search"] = max(worst["encode_search"], enc_corp["err"])
    fix_shapes = check_encode_fixpoint_shapes(torch, dev, enc, enc_corp)
    meas_launches = measurement_main_path(torch)
    codec_st = streaming_main_path(images, ref, bad, bad_wav, enc)
    # the multi-device layer on meshes that repeat the card, each path
    # counted from 0; then the CLI's device and process options
    card = torch.device("cuda", torch.cuda.current_device())
    sp_st = sp_main_path(torch, card, big, ref["stereo6_5min"], enc["big"],
                         enc["ref"])
    dp_st = dp_main_path(torch, card, corp["src"], ctmp / "corpus_wav",
                         enc_corp["src"], ctmp / "enc_xa", ctmp)
    trans = transcode_main_path(torch, card, np.random.default_rng(SEED + 23))
    mesh_cli_checks(ctmp, big, ref["stereo6_5min"], enc["big"], enc["ref"],
                    corp["src"], ctmp / "corpus_wav")

    # ---- phase 5: timings on the card ---------------------------------------
    ms = {}
    bt = torch.from_numpy(staged).to(dev)
    st = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(bt.shape[2], 2)).astype(np.int32)
    ).to(dev)
    for wo in (True, False):
        k = cuda_ms(torch, lambda: cuda_decode.fused_decode_lanes(
            bt, st, bits=6, with_output=wo), inner=20)
        p = cuda_ms(torch, lambda: cuda_decode.fused_decode_lanes_plain(
            bt, st, bits=6, with_output=wo), reps=5)
        ms[("decode_lanes", wo)] = (k, p)
        phase(5, "time_decode_lanes", gpu=repr(gpu),
              shape=f"B={bt.shape[0]},L={bt.shape[2]},bits=6",
              with_output=wo, kernel_ms=f"{k:.6f}", plain_ms=f"{p:.6f}")
    short_ms = short_timings(torch, dev, gpu, short, ref["stereo8_23blocks"])

    stream = stream_timings(torch, dev, gpu, payload_d, state_d, fmt)

    e2e = []
    xa_to_wav(big, device=dev)
    for _ in range(5):
        t0 = time.perf_counter()
        xa_to_wav(big, device=dev)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    e2e_s = statistics.median(e2e)
    total = fmt.samples * fmt.channels
    phase(5, "time_xa_to_wav", gpu=repr(gpu), stream="stereo6_5min",
          samples=total, rounds=rounds, seconds=f"{e2e_s:.6f}",
          msamples_per_s=f"{total / e2e_s / 1e6:.3f}",
          runs=[f"{s:.6f}" for s in e2e])

    # where one decode's time goes, by stage (host clock, synchronized):
    # the three stage functions of ops/decode._decode_payload_stream
    # themselves, then decode_bytes' readback and xa_to_wav's WAV write
    from bjxa_tpu_torch import dump_pcm, dump_riff_header

    stages = {k: [] for k in ("host_copy", "h2d", "fixpoint", "d2h", "wav")}
    for _ in range(5):
        t = [time.perf_counter()]
        host = tdecode.stream_payload_host(memoryview(big)[32:], fmt)
        t.append(time.perf_counter())
        pay = tdecode.stream_payload_upload(host, dev)
        st_d = torch.from_numpy(fmt.initial_state_array()).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        frames, valid = tdecode.stream_decode_on_device(pay, fmt, st_d)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tdecode.check_valid(valid, fmt.channels)
        pcm = frames[: fmt.samples].cpu().numpy()
        t.append(time.perf_counter())
        out = dump_riff_header(fmt.data_len_pcm, fmt.samples_rate,
                               fmt.channels) + dump_pcm(pcm)
        t.append(time.perf_counter())
        if out != ref["stereo6_5min"]:
            raise AssertionError("staged decode WAV != CPU WAV")
        for k, a, b in zip(stages, t, t[1:]):
            stages[k].append((b - a) * 1e3)
    phase(5, "xa_to_wav_stages_ms", gpu=repr(gpu),
          **{k: f"{statistics.median(v):.3f}" for k, v in stages.items()})

    enc_ms = encode_timings(torch, dev, gpu, enc)
    fix_ms = encode_fixpoint_timings(torch, dev, gpu, fix_shapes)
    words_ms, words_corpus = corpus_timings(torch, dev, gpu, corp, enc_corp,
                                            ctmp)
    mesh_ms = mesh_timings(torch, card, gpu, sp_st, dp_st, corp["src"],
                           enc_corp["src"], ctmp)
    ctmp_dir.cleanup()
    meas = measurement_timings(torch, dev, gpu)
    # the words kernel at the headline against the load/store bound measured
    # on the same shape in this run (row 9 of PERF.md)
    measured_8 = meas["loadstore_bound"]["measured_ms"][8]
    phase(5, "decode_words_share_of_measured_bound", gpu=repr(gpu),
          shape="B={},L={},bits={}".format(*WORDS_SHAPES[0]),
          kernel_ms=f"{words_ms[True][0]:.6f}",
          states_only_ms=f"{words_ms[False][0]:.6f}",
          measured_bound_ms=f"{measured_8:.6f}",
          share=f"{measured_8 / words_ms[True][0]:.4f}")
    # the stream kernel against the same measured load/store rate, at its
    # own bytes (the 6-bit row)
    from bjxa_tpu_torch.benchmarks.roofline_bound import words_traffic

    wB, wL, _wbits = WORDS_SHAPES[0]
    rate_6 = (words_traffic(wB, wL, 6)
              / meas["loadstore_bound"]["measured_ms"][6])
    stream["measured_bound_ms"] = stream["bytes"] / rate_6
    phase(5, "decode_stream_share_of_measured_bound", gpu=repr(gpu),
          shape=f"B={fmt.blocks},C={fmt.channels},bits={fmt.bits}",
          kernel_ms=f"{stream['ms']:.6f}",
          measured_gb_per_s=f"{rate_6 / 1e6:.3f}",
          measured_bound_ms=f"{stream['measured_bound_ms']:.6f}",
          share=f"{stream['measured_bound_ms'] / stream['ms']:.4f}")
    bench_children(gpu)
    codec_ms = streaming_timings(torch, dev, gpu, codec_st)

    # each kernel's bound at the shape it was timed at: every input byte
    # read once and every output byte written once over the memory rate, or
    # its integer operations over the integer rate, whichever takes longer
    Bc, S, KC = bt.shape
    eB, eL = -(-parse_xa_header(enc["ref"]).blocks // enc["K"]), 2 * enc["K"]
    wB, wL, wbits = WORDS_SHAPES[0]
    bounds = {
        "decode_lanes": bound(Bc * S * KC + Bc * 32 * KC * 2 + 2 * KC * 8,
                              Bc * 32 * KC * DECODE_OPS_PER_SAMPLE),
        "filter_lanes": bound(2 * 64 * 32 * 2 * 2 + 3 * 64 * 2 * 4 + 2 * 2 * 8,
                              64 * 32 * 2 * FILTER_OPS_PER_SAMPLE),
        # the short stream of the main path: 23 stereo 8-bit blocks, the
        # blocks and state read, frames, end state and validity written
        "decode_short": bound(23 * 2 * 33 + 23 * 32 * 2 * 2 + 2 * 8 * 2
                              + 23 * 2, 23 * 32 * 2 * DECODE_OPS_PER_SAMPLE),
        "encode_search": encode_bound(eB, eL),
        # one search of the corpus batch's blocks: the fixed point's
        # function, whatever rounds it runs
        "encode_fixpoint": encode_bound(*(
            fix_shapes["corpus_batch"]["pcm"].shape[i] for i in (0, 2))),
        "decode_words": bound(words_traffic(wB, wL, wbits),
                              wB * 32 * wL * DECODE_OPS_PER_SAMPLE),
    }

    def timed(name, ms_plain):
        b_ms, b_by = bounds[name]
        return {"ms": ms_plain[0], "plain_ms": ms_plain[1], "bound_ms": b_ms,
                "bound_by": b_by}

    def entry(name, replaces, by_path, timing, source=None, **more):
        """One kernel of the summary.  ``library_ms`` is null throughout:
        no single PyTorch call computes a saturating two-tap recurrence, the
        80-candidate search or these probes."""
        return {"name": name, "route": "cuda",
                "source": f"bjxa_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": worst[name],
                "library_ms": None, **timing, **more}

    summary = {"kernels": [
        entry("decode_lanes", "bjxa_tpu/ops/pallas_decode.py:83",
              {"decode_fixpoint_lanes": fixpoint_lanes_launches,
               "decode_arrays_fixpoint": wrap["decode_arrays_fixpoint"],
               "benchmarks": meas_launches["decode_lanes"],
               **{f"decode_file_sharded_{n}": d["launches"]
                  for n, d in sp_st["decode"].items()},
               "decode_bytes_mesh": sp_st["decode_bytes_launches"]},
              timed("decode_lanes", ms[("decode_lanes", True)]),
              sp_decode_s={str(n): mesh_ms[f"sp_decode_{n}_s"]
                           for n in SP_MESHES},
              also_replaces="bjxa_tpu/ops/pallas_decode.py:141"),
        entry("filter_lanes", "bjxa_tpu/ops/pallas_filter.py:36",
              {"short_decode_old_route":
               short_ms["routes"]["old"]["launches"]["filter_lanes"],
               "decode_batch": wrap["decode_batch"],
               "transcode_step": trans["filter_lanes"]},
              timed("filter_lanes", (
                  short_ms[("filter_lanes", True)]["ms"],
                  short_ms[("filter_lanes", True)]["plain_ms"])),
              eager_ms=short_ms[("filter_lanes", True)]["eager_ms"],
              states_only_ms=short_ms[("filter_lanes", False)]["ms"],
              states_only_eager_ms=short_ms[("filter_lanes", False)][
                  "eager_ms"],
              launch_floor_ms=short_ms["floor"],
              also_replaces="bjxa_tpu/ops/pallas_filter.py:69"),
        entry("decode_short", "bjxa_tpu/ops/pallas_filter.py:36",
              {"xa_to_wav": launches["decode_short"]},
              timed("decode_short", (short_ms["fused"][(23, 2, True)]["ms"],
                                     short_ms["plain_ms"])),
              source="filter_lanes",
              also_replaces="bjxa_tpu/ops/pallas_filter.py:69",
              eager_ms=short_ms["fused"][(23, 2, True)]["eager_ms"],
              states_only_ms=short_ms["fused"][(23, 2, False)]["ms"],
              **{k: short_ms["fused"][(23, 2, True)][k]
                 for k in ("K", "Bc", "rounds", "chain_floor_ms")},
              launch_floor_ms=short_ms["floor"],
              step_cycles=short_ms["step_cycles"],
              sm_clock_mhz=short_ms["clock_mhz"],
              bc_sweep={f"B={B},C={C},Bc={bc},out={wo}": r["ms"]
                        for (B, C, bc, wo), r in short_ms["sweep"].items()},
              xa_to_wav_ms={k: v["ms"] for k, v in
                            short_ms["routes"].items()}),
        entry("encode_search", "bjxa_tpu/ops/pallas_encode.py:52",
              {"wav_to_xa_short": enc["launches"],
               "bench": meas_launches["encode_search"],
               "encode_file_sharded": sp_st["encode"]["launches"],
               "transcode_step": trans["encode_search"]},
              timed("encode_search", enc_ms),
              sp_encode_s=mesh_ms["sp_encode_s"],
              encoder_piece_ms=codec_ms["ms"],
              encoder_piece_plain_ms=codec_ms["plain_ms"]),
        entry("encode_fixpoint", "bjxa_tpu/ops/pallas_encode.py:52",
              {"wav_to_xa": enc["fixpoint_launches"],
               "encode_wav_stream": seg_launches["encode_fixpoint"],
               "encode_corpus": enc_corp["launches"],
               "Encoder.encode": codec_st["launches"],
               "encode_corpus_mesh": dp_st["encode_fixpoint"]},
              {"ms": fix_ms["corpus_batch"]["ms"],
               "plain_ms": fix_ms["corpus_batch"]["plain_ms"],
               "bound_ms": bounds["encode_fixpoint"][0],
               "bound_by": bounds["encode_fixpoint"][1]},
              shape="corpus_batch",
              by_shape={name: {k: r[k] for k in (
                  "ms", "serial_ms", "host_loop_ms", "bound_ms",
                  "chain_floor_ms", "rounds", "K", "Bc")}
                  for name, r in fix_ms.items()}),
        entry("decode_words", "bjxa_tpu/ops/pallas_decode.py:149",
              {"decode_corpus": corp["launches"],
               "bench": meas_launches["decode_words"],
               "decode_corpus_mesh": dp_st["decode_words"]},
              timed("decode_words", words_ms[True]),
              states_only_ms=words_ms[False][0],
              measured_bound_ms=measured_8, corpus_batch=words_corpus,
              also_replaces="bjxa_tpu/ops/pallas_decode.py:237"),
        entry("decode_variants", "benchmarks/bench_load_variants.py:43",
              {"load_variants": meas_launches["load_variants"],
               "store_variants": meas_launches["store_variants"]},
              meas["decode_variants"], ptxas=var_ptx,
              also_replaces="benchmarks/bench_store_variants.py:32"),
        entry("loadstore_bound", "benchmarks/bench_roofline_bound.py:54",
              {"roofline_bound": meas_launches["loadstore_bound"]},
              meas["loadstore_bound"]),
        entry("alu_mix", "tools/encode_pack_falsify.py:152",
              {"encode_pack_falsify": meas_launches["alu_mix"]},
              meas["alu_mix"]),
        entry("decode_stream", "bjxa_tpu/ops/pallas_decode.py:83",
              {"xa_to_wav": launches["decode_stream"],
               "decode_xa_stream": seg_launches["decode_stream"],
               "decode_corpus": over_launches},
              {k: stream[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")},
              also_replaces="bjxa_tpu/ops/pallas_decode.py:141",
              **{k: stream[k] for k in ("states_only_ms", "measured_bound_ms",
                                        "rounds", "K", "Bc")},
              bc_sweep={str(bc): v for bc, v in stream["bc_sweep"].items()}),
    ]}
    phase(5, "total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
