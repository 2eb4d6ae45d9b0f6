"""Ablation: how the ALU probe (``csrc/alu_mix.cu``, kernel 11) lays out its
int16 elements, and its schedule.

The probe's int16 form runs two elements to a 32-bit register (``Packed16``:
16x2 adds spread over two pipes, fused add-max and min, the shift composed
in offset binary from a mask and a 32-bit shift).  This script adds one
form to its own copy of the source only, under the same schedule:
``Widened16``, the form the port had before (each element in a 32-bit
register of its own, narrowed to 16 bits after every operation).  The
schedule is ``kWords`` (E) independent words a thread, loaded as one
vector, over a persistent grid of ``kAluThreads``-thread CTAs.

This script builds ``alu_mix.cu`` once per form, each by its own ``nvcc``
(all at once, the flags of ``ops/_build.py``): the packed form at E in
``WORDS`` x CTA sizes in ``THREADS`` (the sweep that picked the
production's E = 4, 256 threads), and the widened int16 form at the
production's E and CTA size.  It holds every build equal to the plain version
(``encode_pack_falsify.alu_mix_plain``) at ragged shapes and unaligned
views, counts each instantiation's instructions per word and step in its
SASS (``cuobjdump -sass``: the innermost loop with the most instructions,
its branch, compares and uniform-register counter left out, so a counter
kept in a regular register shows as 1/32 of an instruction; a word is one
int32 element or one int16 pair), and times each form at the probe's shape
(``encode_pack_falsify.SHAPE`` x 256 steps) in turns, there and back: in a
CUDA graph of 20 launches (the device alone) and eagerly.

    python -m bjxa_tpu_torch.benchmarks.alu_pack

On the card it needs ``nvcc`` and ``cuobjdump``.  With ``BJXA_PLATFORM=cpu``
it rehearses on the CPU: the production form's plain twin
(``alu_mix_packed_plain`` for int16) and the widened form's
(``alu_mix_plain``) are held to each other and timed on the host clock, and
nothing is built.  Env: ``BENCH_REPS`` (5).  One JSON line per form with the
card's name and power limit: E, the CTA size, ptxas' registers, CTAs an SM,
the SASS count per word and step, and the times (ms) per element type and
mix.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from bjxa_tpu_torch.benchmarks._common import (
    bench_device,
    emit,
    env_int,
    time_ms,
)
from bjxa_tpu_torch.ops import _build
from bjxa_tpu_torch.tools import encode_pack_falsify as probe

#: The sweep of the packed form; the production's E and CTA size first.
WORDS = (4, 1, 2, 8)
THREADS = (256, 128, 512)
#: The lines of alu_mix.cu that a form rewrites.
WORDS_LINE = "constexpr int kWords = 4;  // words a thread: one 16-byte vector\n"
THREADS_LINE = "constexpr int kAluThreads = 256;\n"
FORM_LINE = "template <int MIX>\nusing Form16 = Packed16<MIX>;\n"
#: The step loop's unroll and stride, which the SASS count divides by.
UNROLL = re.compile(
    r"#pragma unroll (\d+)\n  for \(int s = 0; s < kSteps; s \+= (\d+)\)")
WIDENED = """\
// The widened int16 form: each element of a word in a 32-bit register of its
// own, narrowed to 16 bits after every operation, as a 16-bit lane would (C
// promotes short to int, so without the casts the intermediate would keep
// 32 bits).
template <int MIX>
struct Widened16 {
  struct Chain {
    int16_t y[2], x[2];
  };
  __device__ __forceinline__ static int16_t narrow(int v) {
    return static_cast<int16_t>(static_cast<uint16_t>(v));
  }
  __device__ __forceinline__ static Chain start(uint32_t w) {
    const int16_t lo = narrow(static_cast<int>(w & 0xFFFFu));
    const int16_t hi = narrow(static_cast<int>(w >> 16));
    return {{lo, hi}, {lo, hi}};
  }
  template <int P>
  __device__ __forceinline__ static void step(Chain& c) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int16_t y = narrow(narrow(c.y[k] * 3) + c.x[k]);
      if constexpr (MIX == kMixFull) y = static_cast<int16_t>(y >> 2);
      y = narrow(y + 1);
      if constexpr (MIX != kMixMulAdd) {
        y = y < -16384 ? int16_t(-16384) : (y > 16383 ? int16_t(16383) : y);
      }
      c.y[k] = y;
    }
  }
  __device__ __forceinline__ static uint32_t word(const Chain& c) {
    return static_cast<uint16_t>(c.y[0]) |
           (static_cast<uint32_t>(static_cast<uint16_t>(c.y[1])) << 16);
  }
};

"""
ENTRIES = ("bjxa_alu_mix", "bjxa_alu_mix_occupancy")
#: Ragged shapes each build is held to the plain version at, as (n, offset
#: in elements): odd counts, one element, and views off a 16-byte boundary.
CHECKS = ((1, 0), (3, 1), (2047, 0), (7 * 8191, 0), (4099, 1), (4099, 3),
          (4099, 5), (4099, 7))



def forms() -> list[tuple[str, int, int]]:
    """``(form, E, threads)``: the production form first, the packed sweep,
    then the widened int16 form at the production's schedule."""
    packed = [("packed", e, t) for t in THREADS for e in WORDS]
    return packed + [("widened", WORDS[0], THREADS[0])]


def variant_source(form: str, words: int, threads: int) -> str:
    """``alu_mix.cu`` with ``words`` words a thread, ``threads`` a CTA, and
    the int16 form ``form`` (``"packed"`` or ``"widened"``)."""
    src = (_build.CSRC / "alu_mix.cu").read_text()
    if (src.count(WORDS_LINE) != 1 or src.count(THREADS_LINE) != 1
            or src.count(FORM_LINE) != 1):
        raise RuntimeError("alu_mix.cu: the lines alu_pack.py rewrites moved")
    if form not in ("packed", "widened"):
        raise ValueError(f"alu_pack: form {form!r}")
    src = src.replace(WORDS_LINE, WORDS_LINE.replace("4;", f"{words};"))
    src = src.replace(THREADS_LINE, THREADS_LINE.replace("256", str(threads)))
    if form == "widened":
        src = src.replace(FORM_LINE,
                          WIDENED + FORM_LINE.replace("Packed16", "Widened16"))
    return src


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).with_name(name))


def build_forms() -> dict:
    """``{(form, E, threads): (library, registers, sass)}``, one ``nvcc``
    each, all started together; ``sass`` is ``sass_counts`` of the
    library."""
    out_dir = _build.BUILD_DIR / "alu_pack"
    procs = {}
    for key in forms():
        d = out_dir / "{}{}x{}".format(*key)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "alu_mix.cu").write_text(variant_source(*key))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "libalu.so"), str(d / "alu_mix.cu")]
        procs[key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for key, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelBuildError(f"{key}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(d / "libalu.so"))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        sass = subprocess.run([_tool("cuobjdump"), "-sass",
                               str(d / "libalu.so")], capture_output=True,
                              text=True, check=True).stdout
        libs[key] = (lib, regs, sass_counts(sass, key[1],
                                            variant_source(*key)))
    return libs


#: SASS lines: address, then the instruction up to its ';'.
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
#: Loop control in a step loop's body, left out of the count.
_CONTROL = {"BRA", "ISETP", "UISETP", "UIADD3", "NOP"}


def sass_counts(sass: str, words: int, source: str) -> dict:
    """``{"<dtype>+<mix>": {"per_word_step": x, "ops": {opcode: x}}}``:
    the instructions of each instantiation's step loop over the body's
    vectors -- its innermost loop with the most instructions -- divided by
    the steps it holds (unroll x stride x ``words``), loop control left
    out."""
    unroll, stride = map(int, UNROLL.search(source).groups())
    mixes = {v: k for k, v in probe.MIXES.items()}
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        m = re.search(r"alu_mix_kernel.*?(Word32|\w+16)ILi(\d)E",
                      name)
        if not m:
            continue
        code = [(int(a, 16), ins.split()) for a, ins in
                _SASS_LINE.findall(func)]
        code = [(a, ins[1:] if ins[0].startswith("@") else ins)
                for a, ins in code]
        loops = [(int(ins[1], 16), a) for a, ins in code
                 if ins[0] == "BRA" and ins[1].startswith("0x")
                 and int(ins[1], 16) < a]
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo < lo2 <= hi2 < hi for lo2, hi2 in loops)]
        body = max(([ins[0] for a, ins in code if lo <= a <= hi]
                    for lo, hi in inner), key=len, default=[])
        ops = {}
        for op in body:
            if op.split(".")[0] not in _CONTROL:
                ops[op] = ops.get(op, 0) + 1
        steps = unroll * stride * words
        dtype = "int32" if m.group(1) == "Word32" else "int16"
        out[f"{dtype}+{mixes[int(m.group(2))]}"] = {
            "per_word_step": round(sum(ops.values()) / steps, 3),
            "ops": {k: round(v / steps, 3) for k, v in sorted(ops.items())},
        }
    return out


def launcher(lib, x: torch.Tensor, mix: str):
    """``(run, CTAs an SM)``: ``run()`` launches ``lib``'s probe once over
    ``x`` into an output allocated here, as the wrapper does (the same
    address modulo 16, a persistent grid of the occupancy times the SMs),
    on the stream current at the call, and returns it."""
    dev, n, size = x.device, x.numel(), x.element_size()
    fit = lib.bjxa_alu_mix_occupancy(size, probe.MIXES[mix], dev.index)
    _build.check_launch(max(-fit, 0), "bjxa_alu_mix_occupancy")
    ctas = fit * torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.empty(n + 16 // size, dtype=x.dtype, device=dev)
    lead = (x.data_ptr() - buf.data_ptr()) % 16 // size
    out = buf[lead:lead + n].view(x.shape)

    def run():
        err = lib.bjxa_alu_mix(
            x.data_ptr(), out.data_ptr(), n, size, probe.MIXES[mix], ctas,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "bjxa_alu_mix")
        return out

    return run, fit


def _ragged(dtype, n: int, offset: int, device) -> torch.Tensor:
    """``n`` seeded elements of ``dtype`` at ``offset`` elements into their
    buffer, the extremes first."""
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(n + offset)
    x = torch.randint(info.min, info.max + 1, (n + offset,), generator=g,
                      dtype=torch.int64).to(dtype)
    x[offset:offset + 2] = torch.tensor([info.max, info.min])[:n]
    return x.to(device)[offset:]


def rehearse(device, reps: int) -> list[dict]:
    """The CPU rehearsal: the production form's plain twin and the widened
    form's, held to each other and timed on the host clock."""
    twins = {"packed": probe.alu_mix_packed_plain,
             "widened": probe.alu_mix_plain}
    out = []
    for form, fn in twins.items():
        ms = {}
        for dtype in (torch.int32, torch.int16):
            plain = fn if dtype == torch.int16 else probe.alu_mix_plain
            name = str(dtype).removeprefix("torch.")
            for mix in probe.MIXES:
                for n, offset in CHECKS[:2]:
                    x = _ragged(dtype, n, offset, device)
                    if not torch.equal(plain(x, mix=mix),
                                       probe.alu_mix_plain(x, mix=mix)):
                        raise AssertionError(f"{form} {name}+{mix} !="
                                             " plain")
                x = probe.probe_input(dtype, device)
                ms[f"{name}+{mix}"] = time_ms(lambda: plain(x, mix=mix),
                                              device, reps=reps, inner=1)
        out.append(emit({
            "metric": "alu_pack", "form": form, "words": WORDS[0],
            "threads": THREADS[0], "production": form == "packed",
            "registers": None, "ctas_per_sm": None, "sass": None,
            "graph_ms": None, "eager_ms": ms,
        }, device))
    return out


def main() -> list[dict]:
    device = bench_device()
    reps = env_int("BENCH_REPS", 5)
    if device.type != "cuda":
        return rehearse(device, reps)
    libs = build_forms()
    for dtype in (torch.int32, torch.int16):
        for n, offset in CHECKS:
            x = _ragged(dtype, n, offset, device)
            for mix in probe.MIXES:
                want = probe.alu_mix_plain(x, mix=mix)
                for key, (lib, _regs, _sass) in libs.items():
                    if not torch.equal(launcher(lib, x, mix)[0](), want):
                        raise AssertionError(
                            f"{key} {dtype}+{mix} != plain at n={n},"
                            f" offset={offset}")
    from bjxa_tpu_torch.benchmarks.short_stream import graph_ms

    inputs = {dtype: probe.probe_input(dtype, device)
              for dtype in (torch.int32, torch.int16)}
    runs, fits = {}, {}
    for key, (lib, _regs, _sass) in libs.items():
        for dtype, x in inputs.items():
            if key[0] != "packed" and dtype == torch.int32:
                continue  # the same int32 code as the packed build
            for mix in probe.MIXES:
                name = f"{str(dtype).removeprefix('torch.')}+{mix}"
                runs[key, name], fits[key, name] = launcher(lib, x, mix)
    graph = {k: [] for k in runs}
    eager = {k: [] for k in runs}
    order = forms()
    for key in order + order[::-1]:
        for (k, name), run in runs.items():
            if k == key:
                graph[k, name].append(round(graph_ms(run, reps), 6))
                eager[k, name].append(round(time_ms(run, device, reps=reps,
                                                    inner=20), 6))
    return [emit({
        "metric": "alu_pack", "form": form, "words": words,
        "threads": threads, "production": (form, words, threads) == order[0],
        "registers": regs,
        "ctas_per_sm": {n: f for (k, n), f in fits.items()
                        if k == (form, words, threads)},
        "sass": sass,
        "graph_ms": {n: v for (k, n), v in graph.items()
                     if k == (form, words, threads)},
        "eager_ms": {n: v for (k, n), v in eager.items()
                     if k == (form, words, threads)},
    }, device) for (form, words, threads), (_lib, regs, sass) in libs.items()]


if __name__ == "__main__":
    main()
