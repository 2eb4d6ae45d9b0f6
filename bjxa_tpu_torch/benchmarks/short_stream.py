"""The parent-against-change A/B harness of the port's kernels: the
short-stream path and every kernel that shares its chunk schedule or the
words kernel's chunk body, timed in one process against the package of any
checkout.  Run it on a parent checkout and on this one, in turns, inside
one call to compare two versions on one card.

    python bjxa_tpu_torch/benchmarks/short_stream.py [--root DIR]

``--root`` is the checkout whose ``bjxa_tpu_torch`` is imported (this
one by default); run as a file, not with ``-m``, so that the package is
imported from there.  It builds that checkout's kernels and times, through
its public entry points, on seeded random inputs with valid profiles:

* the samples entry (``adpcm_filter_kernel``, kernels 3-4) at B=64, L=2,
  with output and states only, in an eager window of launches (what a
  caller pays a launch, host included) and in a CUDA graph (the device);
* the stream kernel at the 5-minute stream (B=413,438, stereo, 6-bit), and
  the fused short-stream kernel on 23 stereo 8-bit blocks in a CUDA graph;
* the words kernel (kernels 5-6) at 4, 6 and 8 bits, and the five
  load/store variants of ``csrc/decode_variants.cu`` (kernels 8 and 10) on
  the 8-bit bytes, at the ``bench.py`` headline (B=64, L=32,768); on a
  corpus batch (B=20,736, L=32) the words kernel at 4, 6 and 8 bits,
  ``w32+i16`` and ``u8+i16``; the load/store bound (kernel 9) at the
  headline at 4, 6 and 8 bits; the search kernel (kernel 7) at B=101,
  L=8,192, at B=32, L=4,096 (``bench.py``'s) and at the shapes of the
  search's fixed point, 6-bit; eager windows;
* where the checkout has it, the search's fixed point in one launch
  (``cuda_encode.encode_search_fixpoint_lanes``) at a corpus batch (B =
  13,824, L = 32), a streaming ``Encoder`` call (B = 4,096, L = 2), the
  5-minute stream (B = 413,438, L = 2) and a 15 s file, mono and stereo (B
  = 20,672, L = 1 and 2, K = 1,292), with its rounds (and the items its
  rounds searched, where the checkout counts them), on seeded audio-like
  PCM (two sines a lane and noise), beside the serial kernel at the first
  two;
* ``xa_to_wav`` of a 23-block stereo 8-bit stream, host clock,
  synchronised, median of 21, and the device kernels and copies of one
  such decode from ``torch.profiler``;
* the ALU probe (kernel 11, ``tools/encode_pack_falsify.alu_mix``) in its
  six forms (int32 and int16 x ``full``, ``clip``, ``muladd``) at the
  probe's shape, eagerly and in a CUDA graph.

Beside each kernel's time it prints the SHA-1 of its outputs, so two
checkouts' runs show whether any byte moved, ptxas' registers of each
instantiation of the words kernel (``words_registers``, from the build's
log), and the SHA-1 of each kernel function's SASS (``sass_sha1``, from
``cuobjdump -sass`` of the built library), so two checkouts' runs show
which kernels compiled to other code.  The words layout is packed from
the lanes by the checkout's own ``ops.decode.pack_words_from_lanes``.  Eager windows use the checkout's
own ``benchmarks/_common.time_ms``.  Needs the card.  Prints one JSON line
with the card's name and power limit.  Env: ``BENCH_REPS`` (7).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
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


def digest(*tensors) -> str:
    """SHA-1 of the tensors' bytes, in order (None skipped)."""
    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def lanes_inputs(rng, B: int, L: int, bits: int, dev, pack):
    """``(blocks_t uint8[B, 4*bits + 1, L], prof, words, state)``: random
    payload, valid profiles (factor 0-4, range 0-15), int16-range states;
    the words layout packed from the same bytes by ``pack`` (the
    checkout's ``pack_words_from_lanes``)."""
    blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L),
                            dtype=np.uint8)
    blocks_t[:, 0, :] = (rng.integers(0, 5, size=(B, L)) << 4
                         | rng.integers(0, 16, size=(B, L))).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    blocks_t = torch.from_numpy(blocks_t).to(dev)
    prof, words = pack(blocks_t, bits=bits)
    return blocks_t, prof, words, torch.from_numpy(state).to(dev)


def words_registers(log: str) -> dict:
    """``{"<bits>,<with output>": registers}`` of the words kernel's
    instantiations in a ``-Xptxas -v`` log."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"decode_words_kernelILi(\d+)ELb(\d)EE", line)
            key = f"{m.group(1)},{m.group(2)}" if m else None
        m = re.search(r"Used (\d+) registers", line)
        if key is not None and m:
            out[key] = int(m.group(1))
    return out


def sass_digests(library: Path) -> dict | str:
    """``{kernel function: SHA-1 of its SASS}`` of a built library, from
    ``cuobjdump -sass``; the anonymous namespaces' per-file tags are left
    out of the names, so two checkouts' names match."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = Path(home) / "bin" / "cuobjdump"
    if not tool.exists():
        return "not measured (no cuobjdump)"
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines() + ["Function : "]:
        if "Function : " in line:
            if name is not None:
                out[name] = hashlib.sha1("\n".join(body).encode()).hexdigest()
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "anon",
                          line.split("Function : ", 1)[1].strip())
            body = []
        elif name is not None:
            body.append(line.strip())
    out.pop("", None)
    return out


def audio_pcm(rng, B: int, L: int) -> torch.Tensor:
    """Seeded audio-like ``int16[B, 32, L]``: two sines of random pitch a
    lane and noise (``chip_smoke.synth_wav``'s signal)."""
    t = np.arange(B * 32, dtype=np.float64)[:, None] * (2 * np.pi / 44100)
    f = rng.uniform(80.0, 2000.0, size=(2, L))
    sig = 9000 * np.sin(f[0] * t) + 4000 * np.sin(f[1] * t)
    sig += rng.normal(0.0, 400.0, size=(B * 32, L))
    return torch.from_numpy(
        np.clip(sig, -32768, 32767).astype(np.int16).reshape(B, 32, L))


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
    from bjxa_tpu_torch.benchmarks import (load_variants, roofline_bound,
                                           store_variants)
    from bjxa_tpu_torch.benchmarks._common import time_ms
    from bjxa_tpu_torch.ops import _build, cuda_decode, cuda_decode_words
    from bjxa_tpu_torch.ops import cuda_encode, cuda_filter
    from bjxa_tpu_torch.ops.decode import pack_words_from_lanes
    from bjxa_tpu_torch.ops.filter import profile_gains
    from bjxa_tpu_torch.tools import encode_pack_falsify as probe

    if Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"bjxa_tpu_torch imported from {pkg.__file__}")
    reps = int(os.environ.get("BENCH_REPS", "7"))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    out = {"metric": "short_stream", "root": str(root),
           "build_s": time.perf_counter() - t0,
           "words_registers": words_registers(
               _build.library_path().with_suffix(".log").read_text()),
           "sass_sha1": sass_digests(_build.library_path())}
    rng = np.random.default_rng(20261017)

    for dtype in (torch.int32, torch.int16):
        x = probe.probe_input(dtype, dev)
        for mix in probe.MIXES:
            def alu(mix=mix, x=x):
                return probe.alu_mix(x, mix=mix)
            name = f"alu_{str(dtype).removeprefix('torch.')}_{mix}"
            out[f"{name}_sha1"] = digest(alu())
            out[f"{name}_eager_ms"] = time_ms(alu, dev, reps=reps, inner=20)
            out[f"{name}_graph_ms"] = graph_ms(alu, reps)

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

    def timed(name, fn, inner=20):
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = time_ms(fn, dev, reps=reps, inner=inner)
        out[f"{name}_sha1"] = digest(*res)

    for wo in (True, False):
        timed(f"stream{'' if wo else '_states'}",
              lambda wo=wo: cuda_decode.fused_decode_stream(
                  payload, state, bits=bits, channels=C, with_output=wo))

    short = rng.integers(0, 256, size=(2, 23, 33), dtype=np.uint8)
    short[:, :, 0] = (rng.integers(0, 5, size=(2, 23)) << 4
                      | rng.integers(0, 13, size=(2, 23))).astype(np.uint8)
    blocks = torch.from_numpy(short).to(dev)

    def fused():
        return cuda_filter.fused_decode_short(blocks, state, bits=8)

    res = fused()
    torch.cuda.synchronize()
    out["short_graph_ms"] = graph_ms(fused, reps)
    out["short_sha1"] = digest(*res)

    for label, (B, L) in (("headline", (64, 32_768)),
                          ("corpus_batch", (20_736, 32))):
        for nbits in (4, 6):
            _bt, prof, words, wstate = lanes_inputs(
                rng, B, L, nbits, dev, pack_words_from_lanes)
            for wo in (True, False):
                timed(f"words{nbits}_{label}{'' if wo else '_states'}",
                      lambda wo=wo: cuda_decode_words.fused_decode_words(
                          prof, words, wstate, bits=nbits, with_output=wo))
        bt, prof, words, wstate = lanes_inputs(rng, B, L, 8, dev,
                                               pack_words_from_lanes)
        for wo in (True, False):
            timed(f"words_{label}{'' if wo else '_states'}",
                  lambda wo=wo: cuda_decode_words.fused_decode_words(
                      prof, words, wstate, bits=8, with_output=wo))
        headline = label == "headline"
        for s in (load_variants.STORES if headline else ("i16",)):
            timed(f"{label}_w32+{s}", lambda s=s: load_variants.decode_w32(
                prof, words, wstate, store=s))
        for m in (store_variants.MODES if headline else ("i16",)):
            timed(f"{label}_u8+{m}",
                  lambda m=m: store_variants.decode_variant(bt, wstate,
                                                            mode=m))
    for nbits in (4, 6, 8):
        prof, words, wstate = roofline_bound.words_inputs(5, 64, 32_768,
                                                          nbits, dev)
        timed(f"loadstore_bound_{nbits}", lambda: roofline_bound.null_decode(
            prof, words, wstate))
    pcm = torch.from_numpy(rng.integers(
        -(2**15), 2**15, size=(101, 32, 8192)).astype(np.int16)).to(dev)
    zeros = torch.zeros((8192, 2), dtype=torch.int32, device=dev)
    timed("search", lambda: cuda_encode.encode_search_lanes(pcm, zeros,
                                                            bits=6), inner=3)
    pcm = torch.from_numpy(rng.integers(
        -(2**15), 2**15, size=(32, 32, 4096)).astype(np.int16)).to(dev)
    zeros = torch.zeros((4096, 2), dtype=torch.int32, device=dev)
    timed("search_bench", lambda: cuda_encode.encode_search_lanes(
        pcm, zeros, bits=6), inner=4)
    fixpoint = getattr(cuda_encode, "encode_search_fixpoint_lanes", None)
    for label, (B, L, K) in (("corpus_batch", (13_824, 32, 256)),
                             ("encoder_call", (4096, 2, 256)),
                             ("5min", (413_438, 2, 4096)),
                             ("file_mono", (20_672, 1, 1292)),
                             ("file_stereo", (20_672, 2, 1292))):
        pcm = audio_pcm(rng, B, L).to(dev)
        zeros = torch.zeros((L, 2), dtype=torch.int32, device=dev)
        if label in ("corpus_batch", "encoder_call"):
            timed(f"search_{label}", lambda: cuda_encode.encode_search_lanes(
                pcm, zeros, bits=6), inner=1)
        if fixpoint is not None:
            timed(f"fixpoint_{label}", lambda: fixpoint(
                pcm, zeros, bits=6, num_chunks=K), inner=1)
            got = fixpoint(pcm, zeros, bits=6, num_chunks=K)
            out[f"fixpoint_{label}_rounds"] = int(got[4].item())
            if hasattr(got, "searched"):
                out[f"fixpoint_{label}_searched"] = int(got.searched.item())

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
