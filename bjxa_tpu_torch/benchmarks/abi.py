"""Host C engine vs the reference C binary: single-core decode throughput.

Port of ``benchmarks/bench_abi.py``: a whole-file decode through the port's
drop-in C ABI (:mod:`bjxa_tpu_torch.native.abi`, over ctypes, the LE PCM
serialisation included), and through the compiled reference CLI when
``BJXA_REFERENCE_DIR`` holds the reference sources.  The input is the
reference's ``test/square-stereo-8.xa`` where that exists, else a seeded
synthetic stereo 8-bit stream of ``BENCH_ABI_SECONDS`` (30) seconds.

    python -m bjxa_tpu_torch.benchmarks.abi

Prints one JSON line: the median seconds per file and Msamples/s (frames x
channels) over ``BENCH_REPS`` (30) decodes, the host's CPU model, and the
card and its power limit beside them (the decode runs on one host core;
``BJXA_PLATFORM=cpu`` runs it on a machine without a card).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import statistics
import subprocess
import tempfile
import time

import numpy as np

from bjxa_tpu_torch.benchmarks._common import bench_device, emit, env_int



def reference_dir() -> pathlib.Path | None:
    """The reference tree named by ``BJXA_REFERENCE_DIR``, if any."""
    path = os.environ.get("BJXA_REFERENCE_DIR")
    return pathlib.Path(path) if path else None


def cpu_model() -> str:
    """The host CPU's model: ``/proc/cpuinfo``'s ``model name``, or, where
    that says ``unknown`` (some sandboxes hide it), its vendor, family and
    model numbers."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's fields only
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    vendor = fields.get("vendor_id", platform.machine())
    family, model = fields.get("cpu family", "?"), fields.get("model", "?")
    return f"{vendor} family {family} model {model}"


def synthetic_xa(seconds: int, seed: int = 0) -> bytes:
    """A seeded stereo 8-bit 44.1 kHz XA stream: random payload bytes,
    valid profiles (factor 0-4, range 0-12)."""
    from bjxa_tpu_torch import XAFormat, dump_xa_header

    samples = 44100 * seconds
    blocks = -(-samples // 32)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(blocks, 2, 33), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(blocks, 2)) << 4
                    | rng.integers(0, 13, size=(blocks, 2)))
    fmt = XAFormat(data_len=raw.size, samples=samples, samples_rate=44100,
                   bits=8, channels=2, initial_state=((0, 0), (0, 0)))
    return dump_xa_header(fmt.validate()) + raw.tobytes()


def build_reference(tmp: pathlib.Path) -> pathlib.Path | None:
    """The reference CLI compiled from its sources, or None without them."""
    ref = reference_dir()
    src = ref / "src" if ref else None
    if src is None or not src.is_dir():
        return None
    (tmp / "config.h").write_text("")
    exe = tmp / "bjxa-ref"
    subprocess.run(
        ["cc", "-O2", f"-I{tmp}", f"-I{src}", "-o", str(exe)]
        + [str(src / s) for s in ("bjxa.c", "bjxa_decode.c",
                                  "bjxa_encode.c", "libbjxa.c")],
        check=True, capture_output=True)
    return exe


def bench_reference(exe: pathlib.Path, xa: bytes, reps: int) -> float:
    """Median seconds per whole-file decode via the reference CLI."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        subprocess.run([str(exe), "decode"], input=xa, capture_output=True,
                       check=True)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_abi(xa: bytes, reps: int) -> tuple[float, int, bytes]:
    """Median seconds per whole-file decode via the port's C ABI, the
    total int16 samples, and the WAV image of the last run."""
    from bjxa_tpu_torch.native import abi

    L = abi.lib()
    if L is None:
        raise RuntimeError("the C ABI library is off (BJXA_NO_NATIVE)")
    dec = ctypes.c_void_p(L.bjxa_decoder())
    try:
        if L.bjxa_parse_header(dec, xa, len(xa)) != 32:
            raise RuntimeError("bjxa_parse_header refused the input")
        fmt = abi.CFormat()
        L.bjxa_decode_format(dec, ctypes.byref(fmt))
        payload = xa[32:]
        dst = ctypes.create_string_buffer(fmt.data_len_pcm)
        out = ctypes.create_string_buffer(44 + fmt.data_len_pcm)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            L.bjxa_parse_header(dec, xa, len(xa))  # reset progress
            L.bjxa_dump_riff_header(dec, out, 44)
            n = L.bjxa_decode(dec, dst, len(dst), payload, len(payload))
            rc = L.bjxa_dump_pcm(ctypes.byref(out, 44),
                                 ctypes.cast(dst, ctypes.c_void_p),
                                 fmt.data_len_pcm)
            times.append(time.perf_counter() - t0)
            if n != fmt.blocks or rc != 0:
                raise RuntimeError(f"bjxa_decode gave {n} of {fmt.blocks}"
                                   f" blocks, bjxa_dump_pcm {rc}")
    finally:
        L.bjxa_free_decoder(ctypes.byref(dec))
    return statistics.median(times), fmt.data_len_pcm // 2, out.raw


def main() -> dict:
    device = bench_device()
    reps = env_int("BENCH_REPS", 30)
    ref = reference_dir()
    fixture = ref / "test" / "square-stereo-8.xa" if ref else None
    if fixture is not None and fixture.exists():
        xa, name = fixture.read_bytes(), fixture.name
    else:
        seconds = env_int("BENCH_ABI_SECONDS", 30)
        xa, name = synthetic_xa(seconds), f"synthetic stereo 8-bit {seconds} s"
    abi_s, samples, wav = bench_abi(xa, reps)
    record = {
        "metric": "abi_decode",
        "input": name,
        "samples": samples,
        "reps": reps,
        "abi_s_per_file": abi_s,
        "abi_msamples_per_s": samples / abi_s / 1e6,
        "wav_sha1": hashlib.sha1(wav).hexdigest(),
        "cpu": cpu_model(),
    }
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(pathlib.Path(td))
        if exe is not None:
            ref_s = bench_reference(exe, xa, reps)
            record.update(ref_s_per_file=ref_s,
                          ref_msamples_per_s=samples / ref_s / 1e6,
                          speedup_vs_ref=ref_s / abi_s)
    return emit(record, device)


if __name__ == "__main__":
    main()
