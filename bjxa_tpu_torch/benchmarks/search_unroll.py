"""Ablation: how far to unroll the search kernel's sample loop.

``csrc/encode_search.cu`` runs 16 warps of a CTA in 16 instruction streams
(one template per range), so the size of its sample loop decides whether
the streams stay in the instruction cache.  This script builds the
production source with that loop (in the search body it includes,
``csrc/encode_block.cuh``) unrolled 1 (production), 2, 4 and 32 times,
each by its own ``nvcc`` (all at once, flags of ``ops/_build.py``),
holds every variant equal to the production kernel on all four outputs at
every bit depth, then times them in turns (each in order, then in reverse)
at the main path's round shape (B=101, L=8192), ``bench.py``'s (B=32,
L=4096) and the encode corpus batch's (B=13,824, L=32), 6-bit noise.

    python -m bjxa_tpu_torch.benchmarks.search_unroll

Needs the card and ``nvcc``: there is nothing to rehearse on the CPU.  Env:
``BENCH_REPS`` (5).  One JSON line per variant: ptxas' registers and the
two timings (ms) at each shape.
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
from bjxa_tpu_torch.ops import _build, cuda_encode
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

UNROLLS = (1, 2, 4, 32)
SHAPES = ((101, 8192), (32, 4096), (13824, 32))
#: The production sample loop; a variant changes its pragma alone.
LOOP = ("#pragma unroll 1\n"
        "  for (int n = 0; n < kBlockSamples; ++n) {\n"
        "    const int32_t x = tile[n][t];")


def variant_source(unroll: int) -> str:
    """``csrc/encode_block.cuh`` with its sample loop unrolled ``unroll``
    times (32: fully)."""
    src = (_build.CSRC / "encode_block.cuh").read_text()
    if src.count(LOOP) != 1:
        raise RuntimeError("encode_block.cuh: the sample loop has moved")
    pragma = "#pragma unroll" if unroll == 32 else f"#pragma unroll {unroll}"
    return src.replace(LOOP, LOOP.replace("#pragma unroll 1", pragma))


def build_variants() -> dict:
    """``{unroll: (library, registers)}``, one ``nvcc`` per variant."""
    out_dir = _build.BUILD_DIR / "search_unroll"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u in UNROLLS:
        # the kernel beside its variant body: a quoted include looks in
        # the including file's directory first
        src_dir = out_dir / f"u{u}"
        src_dir.mkdir(exist_ok=True)
        (src_dir / "encode_block.cuh").write_text(variant_source(u))
        src = src_dir / "encode_search.cu"
        src.write_text((_build.CSRC / "encode_search.cu").read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-shared", "-o", str(out_dir / f"libsearch_u{u}.so"),
               str(src)]
        procs[u] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for u, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelBuildError(f"unroll {u}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"libsearch_u{u}.so"))
        lib.bjxa_encode_search.argtypes = _build.SIGNATURES[
            "bjxa_encode_search"]
        lib.bjxa_encode_search.restype = ctypes.c_int
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        libs[u] = (lib, regs)
    return libs


def search(lib, pcm: torch.Tensor, state: torch.Tensor, bits: int):
    """One launch of a variant, outputs as ``encode_search_lanes``'."""
    B, _, L = pcm.shape
    dev = pcm.device
    outs = (torch.empty((B, L), dtype=torch.int32, device=dev),
            torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev),
            torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev),
            torch.empty((L, 2), dtype=torch.int32, device=dev))
    err = lib.bjxa_encode_search(
        pcm.data_ptr(), state.data_ptr(), *(t.data_ptr() for t in outs),
        B, L, bits, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "bjxa_encode_search")
    return outs


def main() -> list[dict]:
    device = bench_device()
    if device.type != "cuda":
        raise NoDeviceError("search_unroll builds CUDA variants: it needs"
                            " the card")
    reps = env_int("BENCH_REPS", 5)
    libs = build_variants()
    g = torch.Generator(device=device).manual_seed(5)
    inputs = {}
    for B, L in SHAPES:
        pcm = torch.randint(-(2**15), 2**15, (B, BLOCK_SAMPLES, L),
                            generator=g, device=device).to(torch.int16)
        inputs[B, L] = (pcm, torch.zeros((L, 2), dtype=torch.int32,
                                         device=device))
    for bits in (4, 6, 8):
        pcm, state = inputs[SHAPES[1]]
        want = cuda_encode.encode_search_lanes(pcm, state, bits=bits)
        for u, (lib, _regs) in libs.items():
            got = search(lib, pcm, state, bits)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"unroll {u} != production at {bits}"
                                     " bits")
    ms = {u: {} for u in UNROLLS}
    for u in UNROLLS + UNROLLS[::-1]:
        for (B, L), (pcm, state) in inputs.items():
            t = time_ms(lambda: search(libs[u][0], pcm, state, 6), device,
                        reps=reps, inner=1)
            ms[u].setdefault(f"B={B},L={L}", []).append(round(t, 6))
    return [emit({"metric": "search_unroll_ms", "unroll": u,
                  "production": u == 1, "registers": libs[u][1],
                  "ms": ms[u], "bits": 6}, device) for u in UNROLLS]


if __name__ == "__main__":
    main()
