"""Ablation: how the ``u8`` load of the variants kernel stages its bytes.

A ``u8`` block is 33 rows L bytes apart, so a warp's bytes of a block are
33 separate 32-byte pieces.  ``csrc/decode_variants.cu`` copies them with
``LoadU8Warp`` (``csrc/decode_chunk.cuh``): the warp copies each row's 32
bytes as 16-byte pieces, two threads a row, and each thread takes its
bytes from shared memory (6 KB a stage for a CTA).  ``LoadU8Thread``,
which this script adds to ``decode_chunk.cuh`` for its own builds only,
copies, for each row, the aligned 4-byte word that holds the thread's byte
(16 KB a stage).  This script builds the kernel sources once per form, each
by its own ``nvcc`` (all at once, flags of ``ops/_build.py``): the warp
form at 4 stages (as it is: three blocks in flight while one is filtered,
as in the words kernel), 2 and 8; the thread form at 4 and at 1 (no block
in flight); and ``null``, the warp form at 4 stages with the decode taken
out (each sample the byte plus the profile byte plus its index, summed into
the state), the layout's own load/store yardstick.  It holds each decoding
form equal to the production wrappers (output, end state, rounds) at ragged
shapes and then times the three ``u8`` stores of each in turns (there and
back) at the scripts' shape (B=64, L=32,768), and ``u8+i16`` on a corpus
batch (B=20,736, L=32; not ``null``, whose chunks never settle), each at
the wrapper's own K, on seeded random blocks with valid profiles.

    python -m bjxa_tpu_torch.benchmarks.u8_ring

Needs the card and ``nvcc``: there is nothing to rehearse on the CPU.  Env:
``BENCH_REPS`` (5).  One JSON line per form: ptxas' registers, the
occupancy (CTAs an SM), the dynamic shared memory of a CTA and the timings
(ms).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import torch

from bjxa_tpu_torch.benchmarks import _variants, store_variants
from bjxa_tpu_torch.benchmarks._common import (
    NoDeviceError,
    bench_device,
    emit,
    env_int,
    random_lanes,
    time_ms,
)
from bjxa_tpu_torch.ops import _build
from bjxa_tpu_torch.ops.chunking import CTA_THREADS, word_chunks
from bjxa_tpu_torch.ops.cuda_decode_words import pick_word_chunks

#: (form, stages), the production one first.
FORMS = (("warp", 4), ("warp", 2), ("warp", 8), ("thread", 4), ("thread", 1),
         ("null", 4))
#: The form and the stage count of the u8 load in decode_variants.cu.
FORM = "using LoadU8 = LoadU8Warp<STAGES>;\n"
STAGES = "constexpr int kU8Stages = 4;\n"
#: The decode step of run_chunk in decode_chunk.cuh, and the null form's.
STEP = ("      const uint32_t v = unpack_sample<Load::kBits>(bytes, s);\n"
        "      const int32_t x = filter_step(sign16(v) >> range, k0, k1, p0,"
        " p1);\n")
NULL_STEP = ("      const int32_t x ="
             " static_cast<int32_t>(bytes[s] + pr + s);\n"
             "      p0 += x;\n")
#: The first store policy of decode_chunk.cuh, and the thread form's load
#: policy, which goes before it.
STORES = "struct StoreI16 {\n"
THREAD_LOAD = """\
// The u8 load, a thread at a time: for each of the 32 payload rows the
// thread copies the aligned 4-byte word that holds its byte (cp.async
// copies 4, 8 or 16 bytes), zero-filled past the buffer's end, and takes
// its byte with a shift.  A warp's 32 lanes still hit the same 32-byte
// sector of a row, and no thread waits on another, for any L; but each
// word is copied by up to four threads through L1, and a stage takes 16 KB
// a CTA.
template <int STAGES>
struct LoadU8Thread {
  static constexpr int kBits = 8;
  static constexpr int kRows = 4 * kBits + 1;
  static constexpr int kWords = kRows - 1;  // one word a payload row
  static constexpr int kStages = STAGES;
  static constexpr bool kWarp = false;
  const uint8_t* __restrict__ blocks;
  size_t lanes;
  size_t total;

  struct Item {
    size_t l;
  };
  __device__ __forceinline__ Item item(size_t l, long long) const {
    return {l};
  }
  __device__ __forceinline__ size_t row0(size_t l, long long b) const {
    return (static_cast<size_t>(b) * kRows + 1) * lanes + l;
  }
  __device__ __forceinline__ void issue(const Item& it, uint32_t* ring, int j,
                                        long long b) const {
    uint32_t* slot = ring + (j & (kStages - 1)) * kWords * kThreads;
    const size_t first = row0(it.l, b);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
      const size_t at = (first + r * lanes) & ~static_cast<size_t>(3);
      const size_t left = total - at;  // >= 1: the byte itself is inside
      __pipeline_memcpy_async(&slot[r * kThreads + threadIdx.x], blocks + at,
                              4, left < 4 ? 4 - left : 0);
    }
  }
  __device__ __forceinline__ void sync(const Item&) const {}
  __device__ __forceinline__ int profile(size_t l, long long b) const {
    return blocks[static_cast<size_t>(b) * kRows * lanes + l];
  }
  __device__ __forceinline__ void bytes(const Item& it, const uint32_t* ring,
                                        int j, long long b,
                                        uint32_t (&out)[kWords]) const {
    const uint32_t* slot = ring + (j & (kStages - 1)) * kWords * kThreads;
    const size_t first = row0(it.l, b);
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
      const uint32_t shift =
          8 * static_cast<uint32_t>((first + r * lanes) & 3);
      out[r] = (slot[r * kThreads + threadIdx.x] >> shift) & 0xFFu;
    }
  }
};

"""
#: Timed shapes: the scripts' (B, L) and a corpus batch.
SHAPES = ((64, 32_768), (20_736, 32))
ENTRIES = ("bjxa_decode_variant", "bjxa_decode_variant_occupancy",
           "bjxa_decode_variant_smem")


def variant_sources(form: str, stages: int) -> dict:
    """``{name: text}`` of the sources that differ from ``csrc/``:
    ``decode_variants.cu`` with the u8 load in ``form`` at ``stages``
    stages, and ``decode_chunk.cuh`` without the decode for ``null``, with
    ``LoadU8Thread`` for ``thread``."""
    src = (_build.CSRC / "decode_variants.cu").read_text()
    body = (_build.CSRC / "decode_chunk.cuh").read_text()
    if (src.count(FORM) != 1 or src.count(STAGES) != 1
            or body.count(STEP) != 1 or body.count(STORES) != 1):
        raise RuntimeError("decode_variants.cu: the u8 load has moved")
    if form not in ("warp", "thread", "null"):
        raise ValueError(f"u8_ring: form {form!r}")
    load = "Thread" if form == "thread" else "Warp"
    out = {"decode_variants.cu": src.replace(
        FORM, FORM.replace("Warp", load)).replace(
        STAGES, STAGES.replace("4", str(stages)))}
    if form == "null":
        out["decode_chunk.cuh"] = body.replace(STEP, NULL_STEP)
    elif form == "thread":
        out["decode_chunk.cuh"] = body.replace(STORES, THREAD_LOAD + STORES)
    return out


def build_variants() -> dict:
    """``{(form, stages): (library, registers)}``, one ``nvcc`` each, from
    a copy of ``csrc/`` with that form's sources."""
    out_dir = _build.BUILD_DIR / "u8_ring"
    procs = {}
    for form, stages in FORMS:
        d = out_dir / f"{form}{stages}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for name, text in variant_sources(form, stages).items():
            (d / name).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-shared",
               "-o", str(d / "libu8.so"), str(d / "decode_variants.cu")]
        procs[(form, stages)] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (form, stages), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelBuildError(
                f"{form} at {stages} stages:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{form}{stages}" / "libu8.so"))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        libs[(form, stages)] = (lib, regs)
    return libs


def launcher(lib, blocks_t: torch.Tensor, state: torch.Tensor, mode: str):
    """A function that launches ``u8+mode`` of ``lib`` once at the
    wrapper's own K into outputs allocated here, and returns them as
    ``decode_variant_chunked`` does: the timed loop enqueues the launch
    alone."""
    dev = blocks_t.device
    B, _S, L = blocks_t.shape
    code, rows, dtype = _variants.STORES[mode]
    load = _variants.LOADS["u8"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K, Bc = word_chunks(B, pick_word_chunks(B, L, sms))
    fit = lib.bjxa_decode_variant_occupancy(load, code, dev.index)
    _build.check_launch(max(-fit, 0), "bjxa_decode_variant_occupancy")
    ctas = max(1, min(-(-K * L // CTA_THREADS), fit * sms))
    out = torch.empty((B, rows, L), dtype=dtype, device=dev)
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 + (4 * K * L if K > 1 else 0), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = lib.bjxa_decode_variant(
            blocks_t.data_ptr(), None, state.data_ptr(), out.data_ptr(),
            end.data_ptr(), scratch.data_ptr(), B, L, K, Bc, load, code,
            ctas, dev.index, stream)
        _build.check_launch(err, "bjxa_decode_variant")
        return out, end, scratch[2:3]

    return run


def main() -> list[dict]:
    device = bench_device()
    if device.type != "cuda":
        raise NoDeviceError("u8_ring builds CUDA variants: it needs the card")
    reps = env_int("BENCH_REPS", 5)
    libs = build_variants()
    for B, L in ((23, 33), (61, 129), (300, 3), (1024, 32), (64, 4096)):
        bt = random_lanes(B + L, B, L, _variants.BITS, device)
        st = torch.zeros((L, 2), dtype=torch.int32, device=device)
        for mode in store_variants.MODES:
            want = store_variants.decode_variant_chunked(bt, st, mode=mode)
            for key, (lib, _regs) in libs.items():
                if key[0] == "null":
                    continue
                got = launcher(lib, bt, st, mode)()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"u8+{mode} as {key} !="
                                         f" production at B={B}, L={L}")
    runs = {}
    for B, L in SHAPES:
        bt = random_lanes(7, B, L, _variants.BITS, device)
        st = torch.zeros((L, 2), dtype=torch.int32, device=device)
        for mode in (store_variants.MODES if L > 32 else ("i16",)):
            for key, (lib, _regs) in libs.items():
                if key[0] != "null" or L > 32:
                    runs[(key, f"B={B},L={L}", mode)] = launcher(lib, bt,
                                                                 st, mode)
    ms = {key: [] for key in runs}
    for form in FORMS + FORMS[::-1]:
        for key, run in runs.items():
            if key[0] == form:
                ms[key].append(round(time_ms(run, device, reps=reps,
                                             inner=20), 6))
    load = _variants.LOADS["u8"]
    index = torch.cuda.current_device()
    return [emit({
        "metric": "u8_ring_ms", "form": form, "stages": stages,
        "production": (form, stages) == FORMS[0], "registers": regs,
        "ctas_per_sm": lib.bjxa_decode_variant_occupancy(load, 0, index),
        "smem_bytes": lib.bjxa_decode_variant_smem(load, 0),
        "ms": {f"{shape} u8+{mode}": v for (k, shape, mode), v in ms.items()
               if k == (form, stages)},
    }, device) for (form, stages), (lib, regs) in libs.items()]


if __name__ == "__main__":
    main()
