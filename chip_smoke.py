#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bjxa_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

0. environment: the card, its power limit, torch and CUDA versions;
1. build the CUDA kernels from ``bjxa_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per source, all started together), with each kernel's
   registers and spills;
2. each kernel, every instantiation, against its plain PyTorch version on
   the card at the main paths' shapes and at ragged ones: exact equality;
3. known answers: the saturation vector's WAV SHA-1 (and the reference's
   golden fixtures when ``BJXA_REFERENCE_DIR`` points at them), the
   encoder's ranking-contract vectors, and an encode -> decode round trip
   that gives back the search's own reconstruction;
4. the main paths through the CLI (``python -m bjxa_tpu_torch decode``,
   ``encode`` and ``corpus [--encode]``) on seeded synthetic streams, a
   5-minute stereo file and a 32-file corpus at full size among them,
   byte-compared with the port's plain path on the CPU (or, where the CPU
   would take too long, the card's per-file path, which the CPU checks on a
   few files); the launch counters show the in-process decode, encode and
   corpus runs went through every kernel of their path, and the encode's
   fixed point took as many rounds on the card as on the CPU; the encode
   corpus's one search launch gives the CLI's XA bytes and equals the plain
   search on the card over the first and last blocks of its batch;
5. timings on the card (CUDA events, median of repeats after warm-up), the
   per-stage split of each main path, the encoder's sequential search
   against its fixed point, the words kernel against the lanes kernel and
   the search kernel alone on a corpus batch, and the corpus engine end to
   end, split by the stages it times itself (``Counters.stage_ms``).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
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
FILTER_SHAPES = ((64, 2), (13, 1), (104, 8192))

# Streams through the CLI: name -> (bits, channels, samples).  The first is
# the full-size main-path file: 13,230,000 samples per channel, 413,438
# blocks, ~20.7 MB of XA and ~52.9 MB of PCM (whole-file fixed point).
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

# WAVs through the CLI encoder: name -> (bits, channels, frames, flags).  The
# first is the full-size main-path stream: 13,230,000 frames, 413,438 blocks,
# 52.9 MB of PCM (whole-file fixed point, K = 4096, 8192 lanes).
ENCODE_STREAMS = {
    "stereo6_5min": (6, 2, 44100 * 300, []),
    "mono4_60s": (4, 1, 44100 * 60, ["--bits", "4"]),
    "mono8_60s": (8, 1, 44100 * 60, ["--bits", "8"]),
    "stereo8_23blocks": (8, 2, 23 * 32 - 7, ["--bits", "8"]),  # sequential
    "stereo6_20s_truncate": (6, 2, 44100 * 20, ["--truncate"]),
}
# The mid-size stream: sequential search against the fixed point on the card.
MID_STREAM = (6, 2, 44100 * 60)
# A WAV whose body stops mid-frame, mid-block: (bits, channels, frames, kept
# body bytes).
CUT_WAV = (6, 2, 44100 * 20, 1234567)

# Words-kernel checks, (B, L, bits): the old bench.py headline first (16,384
# stereo 8-bit files x 64 blocks), then ragged shapes.
WORDS_SHAPES = ((64, 32768, 8), (7, 8191, 4), (7, 8191, 6), (300, 3, 4),
                (300, 3, 6))
# The corpus through the CLI, bench.py's corpus shape: 32 stereo 8-bit files
# of 20,672 blocks, 16 files a batch -> 2 batches of L = 32 lanes x 20,736
# blocks (43.7 MB of XA, 84.7 MB of PCM).
CORPUS = (32, 2, 8, 20672, 16)  # files, channels, bits, blocks, batch files
# Seconds of CPU reference decodes after which the rest of the corpus is
# compared with the card's per-file decode instead.
CORPUS_CPU_BUDGET_S = 60.0
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
# Files of the encode corpus also encoded on the CPU (lanes 0-1 and 30-31
# of its batch), and the blocks at each end of the batch that the plain
# search re-runs on the card against the batch's own kernel launch.
ENCODE_CORPUS_CPU_FILES = (0, 15)
ENCODE_CORPUS_PLAIN_BLOCKS = 128

# Stereo int16 saturation vector (tests/test_golden_decode.py): the left
# channel overflows, the right underflows.
SATURATION_XA = (
    "4b574431 42000000 20000000 44ac 08 02 00000000 0000 0000 0000 0000"
    " 00000000 20" + " 7f7f7f7f" * 8 + " 20" + " 80808080" * 8
)
SATURATION_WAV_SHA1 = "56ba3f62bf27ac9fd19cd97bcda06b4db327e612"


#: The kernels of the port, by the name of their ``csrc`` source.
KERNELS = ("decode_lanes", "filter_lanes", "encode_search", "decode_words")


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


def run_cli(*args, platform: str | None):
    """``python -m bjxa_tpu_torch <args>`` in a child process."""
    env = dict(os.environ)
    env.pop("BJXA_PLATFORM", None)
    env.pop("BJXA_ENCODE_FIXPOINT_CHUNKS", None)
    if platform:
        env["BJXA_PLATFORM"] = platform
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    return subprocess.run(
        [sys.executable, "-m", "bjxa_tpu_torch", *map(str, args)],
        cwd=ROOT, env=env, capture_output=True, timeout=600,
    )


def exact_err(a, b) -> int:
    """Max |a - b| over two tensors that must be equal; raises if not."""
    e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if e or a.dtype != b.dtype or not a.equal(b):
        raise AssertionError(f"kernel and plain version differ by {e}")
    return e


def ptxas_report(log: str) -> dict:
    """``{kernel: {"registers": [...], "spill_bytes": n}}`` from the
    ``-Xptxas -v`` log, over every instantiation of each kernel."""
    out = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = next((k for k in KERNELS if f"{k}_kernel" in line), None)
        if name is None:
            continue
        rep = out.setdefault(name, {"registers": set(), "spill_bytes": 0})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep["registers"].add(int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep["spill_bytes"] = max(rep["spill_bytes"], int(m.group(1)),
                                     int(m.group(2)))
    return {k: {"registers": sorted(v["registers"]),
                "spill_bytes": v["spill_bytes"]} for k, v in out.items()}


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


def encode_counted(torch, wav: bytes, bits: int, search: bool, device):
    """The port's whole-file encode of a WAVE image on ``device``, step by
    step as ``wav_to_xa`` takes it, with the search rounds counted through
    the fixed point's ``run`` parameter.  Returns ``(xa bytes, rounds)``."""
    from bjxa_tpu_torch import (
        BLOCK_SAMPLES, RIFF_HEADER_SIZE, XAFormat, dump_xa_header, load_pcm,
        parse_riff_header,
    )
    from bjxa_tpu_torch.ops import encode as tencode

    rf = parse_riff_header(wav)
    pcm = load_pcm(wav[RIFF_HEADER_SIZE:RIFF_HEADER_SIZE + rf.data_len_pcm],
                   rf.channels)
    nblocks = -(-rf.samples // BLOCK_SAMPLES)
    padded = np.zeros((nblocks * BLOCK_SAMPLES, rf.channels), np.int16)
    padded[: rf.samples] = pcm
    lanes = torch.from_numpy(
        padded.reshape(nblocks, BLOCK_SAMPLES, rf.channels)
    ).to(device)
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


def check_encode_kernel(torch, dev, rng) -> int:
    """Phase 2 for the search kernel: every bit depth, the main path's
    round shape and ragged ones, full-scale noise and a sine plus noise,
    random entry states.  Returns the max |kernel - plain| over profiles,
    coded values, reconstruction and end state."""
    from bjxa_tpu_torch.ops import cuda_encode

    worst = 0
    for bits in (4, 6, 8):
        for B, L in ENCODE_SHAPES:
            noise = rng.integers(-(2**15), 2**15, size=(B, 32, L))
            t = np.arange(B * 32)[:, None] * (2 * np.pi / 41.0)
            sine = (20000 * np.sin(t + np.arange(L))).reshape(B, 32, L)
            sine += rng.normal(0.0, 2000.0, size=(B, 32, L))
            for x in (noise, sine):
                pcm = torch.from_numpy(
                    np.clip(x, -32768, 32767).astype(np.int16)
                ).to(dev)
                st = torch.from_numpy(rng.integers(
                    -(2**15), 2**15, size=(L, 2)).astype(np.int32)).to(dev)
                got = cuda_encode.encode_search_lanes(pcm, st, bits=bits)
                want = cuda_encode.encode_search_lanes_plain(pcm, st,
                                                             bits=bits)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    worst = max(worst, exact_err(g, w))
    return worst


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
    plain path on the CPU, with the fixed point's rounds equal on both; a
    cut WAV; the fixed point against the sequential search; and the main
    path in-process with its launches counted.  Returns what phase 5 and
    the summary need."""
    from bjxa_tpu_torch import parse_xa_header, wav_to_xa
    from bjxa_tpu_torch.ops import cuda_decode, cuda_encode, cuda_filter
    from bjxa_tpu_torch.ops.encode import pick_encode_chunks

    wavs, refs, cpu_rounds = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="bjxa_smoke_enc_") as tmp:
        tmp = pathlib.Path(tmp)
        for name, (bits, channels, frames, flags) in ENCODE_STREAMS.items():
            wavs[name] = synth_wav(rng, channels, frames)
            (tmp / f"{name}.wav").write_bytes(wavs[name])
            search = "--truncate" not in flags
            t0 = time.perf_counter()
            refs[name], cpu_rounds[name] = encode_counted(
                torch, wavs[name], bits, search, "cpu")
            cpu_s = time.perf_counter() - t0
            card, card_rounds = encode_counted(torch, wavs[name], bits,
                                               search, dev)
            if card != refs[name] or card_rounds != cpu_rounds[name]:
                raise AssertionError(
                    f"{name}: card took {card_rounds} rounds, the CPU"
                    f" {cpu_rounds[name]}; XA equal: {card == refs[name]}")
            res = run_cli("encode", *flags, tmp / f"{name}.wav",
                          tmp / f"{name}.xa", platform=None)
            if res.returncode != 0 or res.stderr:
                raise AssertionError(f"{name}: CLI exit {res.returncode}"
                                     f" {res.stderr.decode()[-2000:]}")
            if (tmp / f"{name}.xa").read_bytes() != refs[name]:
                raise AssertionError(f"{name}: card XA != CPU XA")
            blocks = parse_xa_header(refs[name]).blocks
            phase(4, "cli_xa_equals_cpu", stream=name, blocks=blocks,
                  K=pick_encode_chunks(blocks, channels) if search else 1,
                  rounds_card=card_rounds, rounds_cpu=cpu_rounds[name],
                  xa_bytes=len(refs[name]), sha1=sha1(refs[name])[:12],
                  cpu_plain_s=f"{cpu_s:.3f}")

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
    phase(4, "fixpoint_equals_sequential", stream="stereo6_60s",
          blocks=nblocks, K=pick_encode_chunks(nblocks, channels),
          rounds=mid_rounds, sequential_bytes_equal=True)

    # the main path in-process, counted: every kernel of it must launch,
    # the search once per fixed-point round
    big, short = wavs["stereo6_5min"], wavs["stereo8_23blocks"]
    for mod in (cuda_decode, cuda_filter, cuda_encode):
        mod.LAUNCHES = 0
    got_big = wav_to_xa(big, device=dev)
    big_launches = cuda_encode.LAUNCHES
    got_short = wav_to_xa(short, 8, device=dev)
    launches = cuda_encode.LAUNCHES
    if got_big != refs["stereo6_5min"] or got_short != refs[
        "stereo8_23blocks"
    ]:
        raise AssertionError("in-process card XA != CPU XA")
    rounds = cpu_rounds["stereo6_5min"]
    if big_launches != rounds:
        raise AssertionError(f"encode kernel launched {big_launches} times,"
                             f" want rounds = {rounds}")
    if launches - big_launches < 1:
        raise AssertionError("the short stream never launched the kernel")
    blocks = parse_xa_header(refs["stereo6_5min"]).blocks
    K = pick_encode_chunks(blocks, 2)
    phase(4, "encode_main_path_launches", K=K, Bc=-(-blocks // K),
          lanes=2 * K, rounds=rounds, encode_search=launches,
          decode_lanes=cuda_decode.LAUNCHES, filter_lanes=cuda_filter.LAUNCHES)
    return {"big": big, "ref": refs["stereo6_5min"], "rounds": rounds,
            "K": K, "launches": launches, "mid": mid, "seq_s": seq_s}


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
    phase(5, "time_encode_search", gpu=repr(gpu),
          shape=f"B={Bc},L={K * C},bits=6", kernel_ms=f"{k:.6f}",
          plain_ms=f"{p:.6f}")

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

    # where one encode's time goes, by stage (host clock, synchronized);
    # each round runs from its search launch to the next one (the equality
    # sync included), the last to the end of the unscramble
    stages = {k: [] for k in ("stage", "h2d", "lanes", "rounds", "deflate",
                              "d2h", "header")}
    for _ in range(5):
        marks = []

        def run(lanes, states):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return tencode.encode_search(lanes, states, bits=6)

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
            bits=6, num_chunks=K, run=run)
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
        ends = marks[1:] + [t_fix]
        stages["stage"].append((t[1] - t[0]) * 1e3)
        stages["h2d"].append((t[2] - t[1]) * 1e3)
        stages["lanes"].append((marks[0] - t[2]) * 1e3)
        stages["rounds"].append([(b - a) * 1e3 for a, b in zip(marks, ends)])
        stages["deflate"].append((t_def - t_fix) * 1e3)
        stages["d2h"].append((t_d2h - t_def) * 1e3)
        stages["header"].append((t_hdr - t_d2h) * 1e3)
    split = {k: f"{statistics.median(v):.3f}" for k, v in stages.items()
             if k != "rounds"}
    per_round = [f"{statistics.median(r):.3f}" for r in zip(*stages["rounds"])]
    phase(5, "wav_to_xa_stages_ms", gpu=repr(gpu), **split,
          round_ms=per_round)

    # sequential against the fixed point on the mid-size stream
    mid = enc["mid"]
    auto = []
    for _ in range(3):
        t0 = time.perf_counter()
        wav_to_xa(mid, device=dev)
        auto.append(time.perf_counter() - t0)
    mrf = parse_riff_header(mid)
    phase(5, "sequential_vs_auto", gpu=repr(gpu), stream="stereo6_60s",
          samples=mrf.samples * mrf.channels,
          sequential_s=f"{enc['seq_s']:.6f}",
          auto_s=f"{statistics.median(auto):.6f}",
          auto_runs=[f"{s:.6f}" for s in auto])
    return k, p


def words_case(rng, B: int, L: int, bits: int):
    """Seeded words-layout inputs: a profile plane with factors 0-7 (5 and
    up invalid), random payload words and int16-range states."""
    prof = (rng.integers(0, 8, size=(B, L)) << 4
            | rng.integers(0, 16, size=(B, L))).astype(np.uint8)
    words = rng.integers(-(2**31), 2**31, size=(B, bits, L), dtype=np.int32)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return prof, words, state


def check_words_kernel(torch, dev, rng) -> int:
    """Phase 2 for the words kernel: both instantiations against the plain
    version at the bench.py headline shape and ragged ones.  Returns the
    max |kernel - plain|."""
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
    from bjxa_tpu_torch.ops import (cuda_decode, cuda_decode_words,
                                    cuda_encode, cuda_filter)

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
    for mod in (cuda_decode, cuda_decode_words, cuda_encode, cuda_filter):
        mod.LAUNCHES = 0
    run = encode_corpus(src, tmp / "enc_xa_inproc", device=dev)
    launches = cuda_encode.LAUNCHES
    if run.converted != n_files or run.failed or launches != 1:
        raise AssertionError(f"in-process encode corpus: {run.converted},"
                             f" {run.failed}, {launches} launches")
    for i in range(n_files):
        if ((tmp / "enc_xa_inproc" / f"w{i:02d}.xa").read_bytes()
                != (tmp / "enc_xa" / f"w{i:02d}.xa").read_bytes()):
            raise AssertionError(f"encode corpus w{i:02d}: in-process != CLI")
    nblocks = -(-frames // 32)
    phase(4, "cli_corpus_encode_equals_wav_to_xa", files=n_files,
          blocks=nblocks, lanes=n_files * channels, encode_search=launches,
          decode_words=cuda_decode_words.LAUNCHES,
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
    batch, the packed H2D against three, the search kernel on the encode
    corpus's batch, and ``decode_corpus`` and ``encode_corpus`` end to end
    and by the stages they time themselves.  Returns the words kernel's
    and its plain version's ms at the headline shape."""
    import shutil

    from bjxa_tpu_torch import decode_corpus, encode_corpus, parse_xa_header
    from bjxa_tpu_torch.ops import cuda_decode, cuda_decode_words as cdw
    from bjxa_tpu_torch.ops import cuda_encode
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
        phase(5, "time_decode_words", gpu=repr(gpu),
              shape=f"B={B},L={L},bits={bits}", with_output=wo,
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
        cprof, cwords, cstate, bits=cbits), reps=5)
    kl = cuda_ms(torch, lambda: cuda_decode.fused_decode_lanes(
        blocks_t, cstate, bits=cbits), reps=5)
    got_w, end_w = cdw.fused_decode_words(cprof, cwords, cstate, bits=cbits)
    got_l, end_l = cuda_decode.fused_decode_lanes(blocks_t, cstate,
                                                  bits=cbits)
    torch.cuda.synchronize()
    exact_err(got_w, got_l)
    exact_err(end_w, end_l)
    phase(5, "time_words_vs_lanes_corpus_batch", gpu=repr(gpu),
          shape=f"B={Bs},L={Lc},bits={cbits}", words_ms=f"{kw:.6f}",
          lanes_ms=f"{kl:.6f}", lanes_over_words=f"{kl / kw:.4f}",
          outputs_equal=True)

    # one packed host->device copy against three of the same bytes
    parts = (buf[:nw], buf[nw:nw + npr], buf[nw + npr:])
    one = cuda_ms(torch, lambda: buf.to(dev, non_blocking=True), inner=5)
    three = cuda_ms(torch, lambda: [t.to(dev, non_blocking=True)
                                    for t in parts], inner=5)
    phase(5, "time_h2d_packed_vs_three", gpu=repr(gpu),
          mbytes=f"{buf.numel() * 4 / 1e6:.3f}", packed_ms=f"{one:.6f}",
          three_ms=f"{three:.6f}")

    # the search kernel on the encode corpus's staged batch (one launch
    # of encode_corpus)
    lanes = enc["lanes"]
    zeros = torch.zeros((lanes.shape[2], 2), dtype=torch.int32, device=dev)
    search_ms = cuda_ms(torch, lambda: cuda_encode.encode_search_lanes(
        lanes, zeros, bits=6), reps=3)
    phase(5, "time_encode_search_corpus_batch", gpu=repr(gpu),
          shape=f"B={lanes.shape[0]},L={lanes.shape[2]},bits=6",
          kernel_ms=f"{search_ms:.6f}",
          us_per_block=f"{search_ms * 1e3 / lanes.shape[0]:.3f}")

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
    # stages it times itself
    en_files, _ch, en_frames = ENCODE_CORPUS
    runs, counted = [], []
    for rep in range(4):
        out = tmp / f"enc_time_{rep}"
        t0 = time.perf_counter()
        res = encode_corpus(enc["src"], out, device=dev)
        dt = time.perf_counter() - t0
        if res.converted != en_files:
            raise AssertionError(f"timed encode corpus: {res.converted}")
        shutil.rmtree(out)
        if rep:
            runs.append(dt)
            counted.append(res.counters)
    e2e = statistics.median(runs)
    phase(5, "time_encode_corpus", gpu=repr(gpu), files=en_files,
          seconds=f"{e2e:.6f}", files_per_s=f"{en_files / e2e:.3f}",
          msamples_per_s=f"{en_files * en_frames * 2 / e2e / 1e6:.3f}",
          runs=[f"{s:.6f}" for s in runs],
          search_share=f"{search_ms / (e2e * 1e3):.4f}")
    phase(5, "encode_corpus_stages_ms", gpu=repr(gpu), **stage_split(counted),
          phase_seconds=f"{time.perf_counter() - t_phase:.3f}")
    return ms[True]


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

    # ---- phase 2: kernels against their plain versions ----------------------
    rng = np.random.default_rng(SEED)
    worst = check_kernels(torch, dev, rng)
    worst["encode_search"] = check_encode_kernel(torch, dev, rng)
    # its own stream, so the later phases keep the inputs they had before
    # the words kernel was added
    worst["decode_words"] = check_words_kernel(
        torch, dev, np.random.default_rng(SEED + 3))
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
        if outs[None] != outs["cpu"] or len(outs[None]) != prefix:
            raise AssertionError("invalid-profile prefix differs")
        phase(4, "cli_invalid_profile", exit=1,
              stderr=repr("bjxa_decode: Protocol error"),
              prefix_bytes=len(outs[None]), equals_cpu=True)

    # the fixed point on the card and on the CPU: same rounds, same output
    big = images["stereo6_5min"]
    fmt = parse_xa_header(big)
    Bp = tdecode.pad_bucket(fmt.blocks)
    K = tdecode.pick_chunks(Bp, fmt.channels)
    staged = tdecode.chunk_lanes_from_bytes(big[32:], fmt, K, Bp)
    fix = {}
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
    rounds = fix["card"][2]

    # the main path in-process, counted: every kernel of it must launch
    short = images["stereo8_23blocks"]
    for mod in (cuda_decode, cuda_filter, cuda_encode):
        mod.LAUNCHES = 0
    got_big = xa_to_wav(big, device=dev)
    big_launches = cuda_decode.LAUNCHES
    got_short = xa_to_wav(short, device=dev)
    launches = {"decode_lanes": cuda_decode.LAUNCHES,
                "filter_lanes": cuda_filter.LAUNCHES}
    if got_big != ref["stereo6_5min"] or got_short != ref["stereo8_23blocks"]:
        raise AssertionError("in-process card WAV != CPU WAV")
    if big_launches != rounds + 1:
        raise AssertionError(f"decode kernel launched {big_launches} times,"
                             f" want rounds + 1 = {rounds + 1}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran:"
                             f" {launches}")
    phase(4, "main_path_launches", K=K, Bc=Bp // K, lanes=K * fmt.channels,
          rounds=rounds, **launches, encode_search=cuda_encode.LAUNCHES)
    enc = encode_main_path(torch, dev, rng)
    ctmp_dir = tempfile.TemporaryDirectory(prefix="bjxa_smoke_corpus_")
    ctmp = pathlib.Path(ctmp_dir.name)
    corp = corpus_main_path(torch, dev, rng, ctmp)
    enc_corp = encode_corpus_main_path(torch, dev, rng, ctmp)
    worst["encode_search"] = max(worst["encode_search"], enc_corp["err"])

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
    samples = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(64, 32, 2)).astype(np.int16)
    ).to(dev)
    gains = torch.from_numpy(
        rng.integers(0, 128, size=(64, 2)).astype(np.int32)
    ).to(dev)
    from bjxa_tpu_torch.ops.filter import profile_gains

    k0, k1, shift, _ = profile_gains(gains)
    st2 = st[:2].contiguous()
    for wo in (True, False):
        k = cuda_ms(torch, lambda: cuda_filter.adpcm_filter_kernel(
            samples, k0, k1, shift, st2, with_output=wo), inner=20)
        p = cuda_ms(torch, lambda: cuda_filter.adpcm_filter_plain(
            samples, k0, k1, shift, st2, with_output=wo), reps=5)
        ms[("filter_lanes", wo)] = (k, p)
        phase(5, "time_filter_lanes", gpu=repr(gpu), shape="B=64,L=2",
              with_output=wo, kernel_ms=f"{k:.6f}", plain_ms=f"{p:.6f}")

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

    # where one decode's time goes, by stage (host clock, synchronized)
    from bjxa_tpu_torch import dump_pcm, dump_riff_header

    stages = {k: [] for k in ("stage", "h2d", "fixpoint", "d2h", "wav")}
    for _ in range(5):
        t = [time.perf_counter()]
        lanes = tdecode.chunk_lanes_from_bytes(big[32:], fmt, K, Bp)
        t.append(time.perf_counter())
        lanes_d = torch.from_numpy(lanes).to(dev)
        state_d = torch.from_numpy(fmt.initial_state_array()).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        frames, _end, valid, _r = tdecode.decode_fixpoint_lanes(
            lanes_d, state_d, bits=fmt.bits, num_chunks=K,
            channels=fmt.channels, b_total=Bp,
        )
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tdecode.check_valid(valid[: fmt.blocks], fmt.channels)
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
    words_ms = corpus_timings(torch, dev, gpu, corp, enc_corp, ctmp)
    ctmp_dir.cleanup()

    summary = {"kernels": [
        {"name": "decode_lanes", "route": "cuda",
         "source": "bjxa_tpu_torch/csrc/decode_lanes.cu",
         "replaces": "bjxa_tpu/ops/pallas_decode.py:83",
         "launches": launches["decode_lanes"],
         "max_abs_err": worst["decode_lanes"],
         "ms": ms[("decode_lanes", True)][0],
         "plain_ms": ms[("decode_lanes", True)][1]},
        {"name": "filter_lanes", "route": "cuda",
         "source": "bjxa_tpu_torch/csrc/filter_lanes.cu",
         "replaces": "bjxa_tpu/ops/pallas_filter.py:36",
         "launches": launches["filter_lanes"],
         "max_abs_err": worst["filter_lanes"],
         "ms": ms[("filter_lanes", True)][0],
         "plain_ms": ms[("filter_lanes", True)][1]},
        {"name": "encode_search", "route": "cuda",
         "source": "bjxa_tpu_torch/csrc/encode_search.cu",
         "replaces": "bjxa_tpu/ops/pallas_encode.py:52",
         "launches": enc["launches"],
         "max_abs_err": worst["encode_search"],
         "ms": enc_ms[0], "plain_ms": enc_ms[1]},
        {"name": "decode_words", "route": "cuda",
         "source": "bjxa_tpu_torch/csrc/decode_words.cu",
         "replaces": "bjxa_tpu/ops/pallas_decode.py:149",
         "launches": corp["launches"],
         "max_abs_err": worst["decode_words"],
         "ms": words_ms[0], "plain_ms": words_ms[1]},
    ]}
    phase(5, "total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
