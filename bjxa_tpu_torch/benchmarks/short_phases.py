"""Ablation: where the fused short-stream kernel's cycles go.

``csrc/filter_lanes.cu``'s ``decode_short_kernel`` (one CTA a short
stream) runs in phases: the raw blocks copied into shared memory, every
block unpacked, the starts of the chunk fixed point set, its rounds
(``csrc/chunk_fixpoint.cuh``, CTA scope), the pass with output, and the
frames stored.  This script builds that source with a ``clock64()`` stamp
after each phase, taken by thread 0 (text substitution into copies of the
source and the header, its own ``nvcc``, flags of ``ops/_build.py``),
holds the stamped kernel equal to the production one, and prints the SM
cycles of each phase at 23 and 61 stereo 8-bit blocks for chunks of 1, 3
and 8 blocks and for K = 1, on seeded random blocks with valid profiles.

    python -m bjxa_tpu_torch.benchmarks.short_phases

Needs the card and ``nvcc``: there is nothing to rehearse on the CPU.  One
JSON line per shape and chunk size.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from bjxa_tpu_torch.benchmarks._common import (
    NoDeviceError,
    bench_device,
    emit,
)
from bjxa_tpu_torch.ops import _build, cuda_filter
from bjxa_tpu_torch.ops.chunking import word_chunks

#: (blocks, channels) timed, 8-bit, and the chunk sizes at each ("B": K = 1).
SHAPES = ((23, 2), (61, 2))
CHUNK_BLOCKS = (1, 3, 8, "B")
#: The most rounds the stamps hold (3 slots a round from slot 2; a later
#: round's stamps all land in slot 59, and the run is refused).
MAX_ROUNDS = 19
STAMP = "if (threadIdx.x == 0) g_stamp[{}] = clock64();"
#: (anchor, stamp slot) in csrc/chunk_fixpoint.cuh: each anchor is kept and
#: the stamp put before it.
HEADER_STAMPS = (
    ("    bool changed = true;\n", "1"),
    ("      const int32_t* in = starts + cur * 2 * items;\n",
     "min(2 + 3 * rounds, 59)"),
    ("      scope.sync();\n      ++rounds;\n", "min(3 + 3 * rounds, 59)"),
    ("      ++rounds;\n", "min(4 + 3 * rounds, 59)"),
    ("  if (first == 0) scope.finish(rounds);\n", "60"),
)
#: The same in csrc/filter_lanes.cu's decode_short_kernel.
KERNEL_STAMPS = (
    ("  extern __shared__ uint4 smem[];\n  const Staged s = carve(smem, B, C);\n"
     "  // the raw blocks", "0"),
    ("  // a thread a block (c, b)", "61"),
    ("  run_staged<WITH_OUTPUT>(s, state, frames, end, rounds, B, C, K, Bc);\n",
     "62"),
    ("}\n\n// bjxa_filter_lanes with few lanes", "63"),
)
READ = ('\nextern "C" int bjxa_short_stamps(void* dst) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
        "      dst, bjxa::g_stamp, sizeof(long long) * 64));\n}\n")


def _stamped(src: str, stamps) -> str:
    for anchor, slot in stamps:
        if src.count(anchor) != 1:
            raise RuntimeError(f"short_phases: anchor {anchor!r} has moved")
        indent = anchor[: len(anchor) - len(anchor.lstrip())]
        src = src.replace(anchor, indent + STAMP.format(slot) + "\n" + anchor)
    return src


def variant_sources() -> tuple[str, str]:
    """``(filter_lanes.cu, chunk_fixpoint.cuh)`` with the stamps."""
    header = (_build.CSRC / "chunk_fixpoint.cuh").read_text()
    header = _stamped(header, HEADER_STAMPS).replace(
        "namespace bjxa {\n", "namespace bjxa {\n"
        "static __device__ long long g_stamp[64];  // thread 0's clock64()\n",
        1)
    kernel = _stamped((_build.CSRC / "filter_lanes.cu").read_text(),
                      KERNEL_STAMPS)
    return kernel + READ, header


def build_variant() -> ctypes.CDLL:
    """The stamped kernel as its own library, one ``nvcc``."""
    out_dir = _build.BUILD_DIR / "short_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernel, header = variant_sources()
    (out_dir / "filter_lanes.cu").write_text(kernel)
    (out_dir / "chunk_fixpoint.cuh").write_text(header)
    so = out_dir / "libshort_phases.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
         "-o", str(so), str(out_dir / "filter_lanes.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise _build.KernelBuildError(res.stdout[-2000:] + res.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.bjxa_decode_short.argtypes = _build.SIGNATURES["bjxa_decode_short"]
    lib.bjxa_decode_short.restype = ctypes.c_int
    lib.bjxa_short_stamps.argtypes = (ctypes.c_void_p,)
    lib.bjxa_short_stamps.restype = ctypes.c_int
    return lib


def run_variant(lib, blocks: torch.Tensor, state: torch.Tensor, chunks: int):
    """One launch of the stamped kernel at ``chunks``: ``(frames, end,
    valid, rounds, stamps)``."""
    dev = blocks.device
    C, B, _S = blocks.shape
    K, Bc = word_chunks(B, chunks)
    frames = torch.empty((B * 32, C), dtype=torch.int16, device=dev)
    end = torch.empty((C, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    rounds = torch.empty(1, dtype=torch.int32, device=dev)
    err = lib.bjxa_decode_short(
        blocks.data_ptr(), state.data_ptr(), frames.data_ptr(),
        end.data_ptr(), valid.data_ptr(), rounds.data_ptr(), B, C, K, Bc, 8,
        1, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "bjxa_decode_short (stamped)")
    torch.cuda.synchronize(dev)
    buf = (ctypes.c_longlong * 64)()
    _build.check_launch(lib.bjxa_short_stamps(ctypes.addressof(buf)),
                        "bjxa_short_stamps")
    return frames, end, valid, rounds, list(buf)


def phases(stamps: list, rounds: int, K: int) -> dict:
    """SM cycles of each phase from thread 0's stamps."""
    t = stamps
    out = {"copy": t[61] - t[0], "unpack": t[62] - t[61]}
    if K > 1:
        out["starts"] = t[1] - t[62]
        out["round_work"] = [t[3 + 3 * r] - t[2 + 3 * r] for r in range(rounds)]
        out["round_sync"] = [t[4 + 3 * r] - t[3 + 3 * r] for r in range(rounds)]
        out["output_pass"] = t[60] - t[4 + 3 * (rounds - 1)]
    else:
        out["output_pass"] = t[60] - t[62]
    out["store"] = t[63] - t[60]
    out["total"] = t[63] - t[0]
    return out


def main() -> list[dict]:
    device = bench_device()
    if device.type != "cuda":
        raise NoDeviceError("short_phases builds a CUDA variant: it needs the"
                            " card")
    lib = build_variant()
    g = torch.Generator(device=device).manual_seed(11)
    records = []
    for B, C in SHAPES:
        blocks = torch.randint(0, 256, (C, B, 33), generator=g, device=device,
                               dtype=torch.uint8)
        blocks[:, :, 0] = (
            torch.randint(0, 5, (C, B), generator=g, device=device) << 4
            | torch.randint(0, 16, (C, B), generator=g, device=device)
        ).to(torch.uint8)
        state = torch.randint(-(2**15), 2**15, (C, 2), generator=g,
                              device=device, dtype=torch.int32)
        for bc in CHUNK_BLOCKS:
            chunks = -(-B // (B if bc == "B" else bc))
            K, Bc = word_chunks(B, chunks)
            want = cuda_filter.fused_decode_short(blocks, state, bits=8,
                                                  chunks=chunks)
            for _ in range(3):  # the last launch's stamps, warm
                *got, stamps = run_variant(lib, blocks, state, chunks)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"stamped kernel != production at B={B},"
                                     f" C={C}, K={K}")
            rounds = int(got[3].item())
            if rounds > MAX_ROUNDS:
                raise AssertionError(f"{rounds} rounds: more than the stamps"
                                     " hold")
            records.append(emit({
                "metric": "short_phases_cycles", "B": B, "C": C, "bits": 8,
                "K": K, "Bc": Bc, "rounds": rounds,
                **phases(stamps, rounds, K)}, device))
    return records


if __name__ == "__main__":
    main()
