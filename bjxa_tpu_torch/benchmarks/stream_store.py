"""Ablation: how the stream kernel writes its frames.

``csrc/decode_stream.cu`` packs each block's 32 samples into 16 words and
writes 64 contiguous bytes a thread with 16-byte stores (stereo lanes swap
halves first).  This script builds that source twice, each by its own
``nvcc`` (both at once, flags of ``ops/_build.py``): as it is (``vec``),
and with one ``int16`` store a sample at stride C instead (``i16``).  It
holds both equal to the production kernel (frames, end state, rounds) at
every bit depth and channel count, then times them in turns (``vec``,
``i16``, ``i16``, ``vec``) at the 5-minute stream's shape (B=413,438
blocks, stereo, 6-bit, the wrapper's own K) on a seeded random payload
with valid profiles.

    python -m bjxa_tpu_torch.benchmarks.stream_store

Needs the card and ``nvcc``: there is nothing to rehearse on the CPU.  Env:
``BENCH_REPS`` (5).  One JSON line per store: ptxas' registers, the round
count and the two timings (ms).
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from bjxa_tpu_torch.benchmarks._common import (
    NoDeviceError,
    bench_device,
    emit,
    env_int,
    time_ms,
)
from bjxa_tpu_torch.ops import _build, cuda_decode
from bjxa_tpu_torch.ops.chunking import CTA_THREADS

STORES = ("vec", "i16")
#: The 5-minute stream: blocks, channels, bits.
SHAPE = (413_438, 2, 6)
#: The production store: each sample packed into its block's words ...
PACK = ("        const uint32_t h = static_cast<uint32_t>(x) & 0xFFFFu;\n"
        "        pk[s / 2] = (s & 1) ? pk[s / 2] | (h << 16) : h;\n")
#: ... and the block's words written at once.
STORE = "    if constexpr (WITH_OUTPUT) store_block<C>(frames, b, c, pk);\n"
#: The ``i16`` variant's store in place of both.
I16 = ("        frames[(static_cast<size_t>(b) * kBlockSamples + s) * C"
       " + c] =\n"
       "            static_cast<int16_t>(x);\n")


def variant_source(store: str) -> str:
    """``csrc/decode_stream.cu`` as it is (``vec``) or with one ``int16``
    store a sample (``i16``)."""
    src = (_build.CSRC / "decode_stream.cu").read_text()
    if src.count(PACK) != 1 or src.count(STORE) != 1:
        raise RuntimeError("decode_stream.cu: the frame store has moved")
    if store == "vec":
        return src
    if store != "i16":
        raise ValueError(f"stream_store: store {store!r}")
    return src.replace(PACK, I16).replace(STORE, "")


def build_variants() -> dict:
    """``{store: (library, registers)}``, one ``nvcc`` per variant."""
    out_dir = _build.BUILD_DIR / "stream_store"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for store in STORES:
        src = out_dir / f"decode_stream_{store}.cu"
        src.write_text(variant_source(store))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-shared", "-o", str(out_dir / f"libstream_{store}.so"),
               str(src)]
        procs[store] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    libs = {}
    for store, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelBuildError(f"store {store}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"libstream_{store}.so"))
        for name in ("bjxa_decode_stream", "bjxa_decode_stream_occupancy"):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        libs[store] = (lib, regs)
    return libs


def launcher(lib, payload: torch.Tensor, state: torch.Tensor, *,
             bits: int, channels: int):
    """A function that launches a variant once at the wrapper's own K
    into outputs allocated here, and returns them as
    ``fused_decode_stream`` does: the timed loop enqueues the launch
    alone."""
    dev = payload.device
    B = payload.numel() // (channels * (4 * bits + 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K, Bc = cuda_decode.pick_stream_chunks(B, channels, sms)
    fit = lib.bjxa_decode_stream_occupancy(bits, channels, 1, dev.index)
    _build.check_launch(max(-fit, 0), "bjxa_decode_stream_occupancy")
    ctas = max(1, min(-(-K * channels // CTA_THREADS), fit * sms))
    frames = torch.empty((B * 32, channels), dtype=torch.int16, device=dev)
    end = torch.empty((channels, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 + (4 * K * channels if K > 1 else 0),
                          dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = lib.bjxa_decode_stream(
            payload.data_ptr(), state.data_ptr(), frames.data_ptr(),
            end.data_ptr(), scratch.data_ptr(), B, channels, K, Bc, bits, 1,
            ctas, dev.index, stream)
        _build.check_launch(err, "bjxa_decode_stream")
        return frames, end, scratch[2:3]

    return run


def random_stream(g: torch.Generator, B: int, channels: int, bits: int,
                  device: torch.device):
    """Seeded ``(payload uint8[B*C*S], state int32[C, 2])``: random bytes,
    valid profiles (factor 0-4, range 0-15)."""
    S = 4 * bits + 1
    raw = torch.randint(0, 256, (B, channels, S), generator=g, device=device,
                        dtype=torch.uint8)
    factor = torch.randint(0, 5, (B, channels), generator=g, device=device)
    shift = torch.randint(0, 16, (B, channels), generator=g, device=device)
    raw[:, :, 0] = (factor << 4 | shift).to(torch.uint8)
    state = torch.randint(-(2**15), 2**15, (channels, 2), generator=g,
                          device=device, dtype=torch.int32)
    return raw.reshape(-1), state


def main() -> list[dict]:
    device = bench_device()
    if device.type != "cuda":
        raise NoDeviceError("stream_store builds CUDA variants: it needs the"
                            " card")
    reps = env_int("BENCH_REPS", 5)
    libs = build_variants()
    g = torch.Generator(device=device).manual_seed(7)
    for bits in (4, 6, 8):
        for channels in (1, 2):
            payload, state = random_stream(g, 997, channels, bits, device)
            want = cuda_decode.fused_decode_stream(payload, state, bits=bits,
                                                   channels=channels)
            for store, (lib, _regs) in libs.items():
                got = launcher(lib, payload, state, bits=bits,
                               channels=channels)()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"store {store} != production at"
                                         f" {bits} bits, C={channels}")
    B, channels, bits = SHAPE
    payload, state = random_stream(g, B, channels, bits, device)
    runs = {store: launcher(lib, payload, state, bits=bits,
                            channels=channels)
            for store, (lib, _regs) in libs.items()}
    rounds = int(runs["vec"]()[2].item())
    K, Bc = cuda_decode.pick_stream_chunks(
        B, channels, torch.cuda.get_device_properties(
            device).multi_processor_count)
    ms = {store: [] for store in STORES}
    for store in STORES + STORES[::-1]:
        ms[store].append(round(time_ms(runs[store], device, reps=reps,
                                       inner=20), 6))
    return [emit({"metric": "stream_store_ms", "store": store,
                  "production": store == "vec", "registers": libs[store][1],
                  "ms": ms[store], "B": B, "C": channels, "bits": bits,
                  "K": K, "Bc": Bc, "rounds": rounds}, device)
            for store in STORES]


if __name__ == "__main__":
    main()
