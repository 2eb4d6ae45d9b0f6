"""The short-stream path and the kernels that share its schedule, timed in
one process against the package of any checkout: run it on a parent
checkout and on this one, in turns, inside one call to compare two
versions on one card.

    python bjxa_tpu_torch/benchmarks/short_stream.py [--root DIR]

``--root`` is the checkout whose ``bjxa_tpu_torch`` is imported (this
one by default); run as a file, not with ``-m``, so that the package is
imported from there.  It builds that checkout's kernels and times, on
seeded random inputs with valid profiles:

* the samples entry (``adpcm_filter_kernel``, kernels 3-4) at B=64, L=2,
  with output and states only, in an eager window of launches (what a
  caller pays a launch, host included) and in a CUDA graph (the device);
* the stream kernel at the 5-minute stream (B=413,438, stereo, 6-bit) and
  the words kernel at the ``bench.py`` headline (B=64, L=32,768, 8-bit)
  and a corpus batch (B=20,736, L=32, 8-bit), eager windows;
* ``xa_to_wav`` of a 23-block stereo 8-bit stream, host clock,
  synchronised, median of 21, and the device kernels and copies of one
  such decode from ``torch.profiler``.

Eager windows use the checkout's own ``benchmarks/_common.time_ms``.
Needs the card.  Prints one JSON line with the card's name and power
limit.  Env: ``BENCH_REPS`` (7).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]


def graph_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median ms of one ``fn()`` on the device alone: ``inner`` calls
    captured in one CUDA graph, its replays timed by CUDA events (the
    host's cost per call, which an eager window of a kernel this short
    measures instead, drops out; each launch still pays its node's launch
    latency)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # first use (the build, occupancy queries) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def short_xa(pkg, rng) -> bytes:
    """A 23-block stereo 8-bit XA image: random payload, valid profiles."""
    raw = rng.integers(0, 256, size=(23, 2, 33), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(23, 2)) << 4
                    | rng.integers(0, 13, size=(23, 2))).astype(np.uint8)
    fmt = pkg.XAFormat(data_len=raw.size, samples=23 * 32 - 7,
                       samples_rate=44100, bits=8, channels=2,
                       initial_state=((0, 0), (0, 0))).validate()
    hdr = bytearray(pkg.dump_xa_header(fmt))
    struct.pack_into("<4h", hdr, 20, 1000, -2000, 3000, -4000)
    return bytes(hdr) + raw.tobytes()


def device_ops(fn) -> dict | str:
    """Device kernels and copies of one ``fn()`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return "not measured"
    return {"kernels": sum(not n.startswith(("Memcpy", "Memset"))
                           for n in names),
            "h2d": sum(n.startswith("Memcpy HtoD") for n in names),
            "d2h": sum(n.startswith("Memcpy DtoH") for n in names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("short_stream: needs a CUDA card", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import bjxa_tpu_torch as pkg
    from bjxa_tpu_torch.benchmarks._common import time_ms
    from bjxa_tpu_torch.ops import _build, cuda_decode, cuda_decode_words
    from bjxa_tpu_torch.ops import cuda_filter
    from bjxa_tpu_torch.ops.filter import profile_gains

    if Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"bjxa_tpu_torch imported from {pkg.__file__}")
    reps = int(os.environ.get("BENCH_REPS", "7"))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    out = {"metric": "short_stream", "root": str(root),
           "build_s": time.perf_counter() - t0}
    rng = np.random.default_rng(20261017)

    samples = torch.from_numpy(rng.integers(
        -(2**15), 2**15, size=(64, 32, 2)).astype(np.int16)).to(dev)
    k0, k1, shift, _ = (t.contiguous() for t in profile_gains(
        torch.from_numpy(rng.integers(0, 128, size=(64, 2)).astype(
            np.int32)).to(dev)))
    state2 = torch.from_numpy(rng.integers(
        -(2**15), 2**15, size=(2, 2)).astype(np.int32)).to(dev)
    for wo in (True, False):
        def call(wo=wo):
            return cuda_filter.adpcm_filter_kernel(samples, k0, k1, shift,
                                                   state2, with_output=wo)
        name = "filter_lanes" if wo else "filter_lanes_states"
        out[f"{name}_eager_ms"] = time_ms(call, dev, reps=reps, inner=20)
        out[f"{name}_graph_ms"] = graph_ms(call, reps)

    B, C, bits = 413_438, 2, 6
    payload = torch.from_numpy(rng.integers(
        0, 256, size=(B, C, 4 * bits + 1), dtype=np.uint8)).to(dev)
    payload[:, :, 0] = torch.from_numpy(
        (rng.integers(0, 5, size=(B, C)) << 4
         | rng.integers(0, 16, size=(B, C))).astype(np.uint8)).to(dev)
    payload = payload.reshape(-1)
    state = torch.from_numpy(rng.integers(
        -(2**15), 2**15, size=(C, 2)).astype(np.int32)).to(dev)
    for wo in (True, False):
        out[f"stream{'' if wo else '_states'}_ms"] = time_ms(
            lambda wo=wo: cuda_decode.fused_decode_stream(
                payload, state, bits=bits, channels=C, with_output=wo),
            dev, reps=reps, inner=20)

    for label, (B, L) in (("headline", (64, 32_768)),
                          ("corpus_batch", (20_736, 32))):
        prof = torch.from_numpy((rng.integers(0, 5, size=(B, L)) << 4
                                 | rng.integers(0, 16, size=(B, L))).astype(
                                     np.uint8)).to(dev)
        words = torch.from_numpy(rng.integers(
            -(2**31), 2**31, size=(B, 8, L), dtype=np.int64).astype(
                np.int32)).to(dev)
        wstate = torch.from_numpy(rng.integers(
            -(2**15), 2**15, size=(L, 2)).astype(np.int32)).to(dev)
        for wo in (True, False):
            out[f"words_{label}{'' if wo else '_states'}_ms"] = time_ms(
                lambda wo=wo: cuda_decode_words.fused_decode_words(
                    prof, words, wstate, bits=8, with_output=wo),
                dev, reps=reps, inner=20)

    xa = short_xa(pkg, rng)
    want = pkg.xa_to_wav(xa, device="cpu")
    if pkg.xa_to_wav(xa, device=dev) != want:
        raise AssertionError("short stream: card WAV != CPU WAV")
    times = []
    for _ in range(21):
        t0 = time.perf_counter()
        pkg.xa_to_wav(xa, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["short_xa_to_wav_ms"] = statistics.median(times)
    out["short_xa_to_wav_device"] = device_ops(
        lambda: pkg.xa_to_wav(xa, device=dev))
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
