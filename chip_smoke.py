#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bjxa_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

0. environment: the card, its power limit, torch and CUDA versions;
1. build the CUDA kernels from ``bjxa_tpu_torch/csrc`` (nvcc, sm_90a);
2. each kernel, both instantiations, against its plain PyTorch version on
   the card at the main path's shapes and at ragged ones: exact equality;
3. known answers: the saturation vector's WAV SHA-1 (and the reference's
   golden fixtures when ``BJXA_REFERENCE_DIR`` points at them);
4. the main path through the CLI (``python -m bjxa_tpu_torch decode``) on
   seeded synthetic streams, a 5-minute stereo 6-bit file at full size
   among them, byte-compared with the port's plain path on the CPU; the
   launch counters show the in-process decode went through both kernels;
5. timings on the card (CUDA events, median of repeats after warm-up).

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

# Stereo int16 saturation vector (tests/test_golden_decode.py): the left
# channel overflows, the right underflows.
SATURATION_XA = (
    "4b574431 42000000 20000000 44ac 08 02 00000000 0000 0000 0000 0000"
    " 00000000 20" + " 7f7f7f7f" * 8 + " 20" + " 80808080" * 8
)
SATURATION_WAV_SHA1 = "56ba3f62bf27ac9fd19cd97bcda06b4db327e612"


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


def run_cli(xa: pathlib.Path, wav: pathlib.Path, platform: str | None):
    """``python -m bjxa_tpu_torch decode xa wav`` in a child process."""
    env = dict(os.environ)
    env.pop("BJXA_PLATFORM", None)
    if platform:
        env["BJXA_PLATFORM"] = platform
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    return subprocess.run(
        [sys.executable, "-m", "bjxa_tpu_torch", "decode", str(xa),
         str(wav)],
        cwd=ROOT, env=env, capture_output=True, timeout=600,
    )


def check_kernels(torch, dev, rng):
    """Phase 2: both kernels, both instantiations, against their plain
    versions on the card.  Returns the max |kernel - plain| per kernel."""
    from bjxa_tpu_torch.ops import cuda_decode, cuda_filter
    from bjxa_tpu_torch.ops.filter import profile_gains

    def states(L):
        return torch.from_numpy(
            rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
        ).to(dev)

    def err(a, b):
        e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        if e or not torch.equal(a, b):
            raise AssertionError(f"kernel and plain version differ by {e}")
        return e

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


def main() -> int:
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
    from bjxa_tpu_torch.ops import _build, cuda_decode, cuda_filter
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
    regs = sorted(set(int(r) for r in re.findall(r"Used (\d+) registers", log)))
    phase(1, "build", seconds=f"{time.perf_counter() - t0:.3f}",
          fresh=fresh, library=so.name, registers_per_thread=regs)

    # ---- phase 2: kernels against their plain versions ----------------------
    rng = np.random.default_rng(SEED)
    worst = check_kernels(torch, dev, rng)
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
            res = run_cli(tmp / f"{name}.xa", tmp / f"{name}.wav", None)
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
            res = run_cli(tmp / "bad.xa", tmp / f"bad_{plat}.wav", plat)
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
    cuda_decode.LAUNCHES = 0
    cuda_filter.LAUNCHES = 0
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
          rounds=rounds, **launches)

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
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
