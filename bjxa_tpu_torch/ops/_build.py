"""Build and load the hand-written CUDA kernels of ``bjxa_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them started together, and the objects are linked into
ONE shared library with a plain C interface, at first use, and loaded with
:mod:`ctypes`.  The library lands in ``bjxa_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused by every later
process.  The compilers' reports (``-Xptxas -v``: registers, spills) are
kept beside it as ``<name>.log``.

A failed build raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: every pointer and the stream is a void*, every int an int
# (an element count a long long).
SIGNATURES = {
    # blocks_t, state, pcm, end, B, L, bits, with_output, device, stream
    "bjxa_decode_lanes": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # prof, words, state, pcm, end, scratch, B, L, K, Bc, bits, with_output,
    # ctas, device, stream
    "bjxa_decode_words": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P),
    # bits, with_output, device
    "bjxa_decode_words_occupancy": (_I, _I, _I),
    # payload, state, frames, end, scratch, B, C, K, Bc, bits, with_output,
    # ctas, device, stream
    "bjxa_decode_stream": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P),
    # bits, channels, with_output, device
    "bjxa_decode_stream_occupancy": (_I, _I, _I, _I),
    # samples, k0, k1, shift, state, pcm, end, B, L, with_output, device,
    # stream
    "bjxa_filter_lanes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # blocks, state, frames, end, valid, rounds, B, C, K, Bc, bits,
    # with_output, device, stream
    "bjxa_decode_short": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    # device, stream
    "bjxa_empty_launch": (_I, _P),
    # pcm, state, profiles, coded, recon, end, B, L, bits, device, stream
    "bjxa_encode_search": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # pcm, state, profiles, coded, recon, end, scratch, B, L, K, Bc, bits,
    # ctas, device, stream
    "bjxa_encode_fixpoint": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    # bits, device
    "bjxa_encode_fixpoint_occupancy": (_I, _I),
    # first (blocks_t | prof), words, state, out, end, scratch, B, L, K, Bc,
    # load, store, ctas, device, stream
    "bjxa_decode_variant": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P),
    # load, store, device
    "bjxa_decode_variant_occupancy": (_I, _I, _I),
    # load, store
    "bjxa_decode_variant_smem": (_I, _I),
    # prof, words, state, out, end, scratch, B, L, bits, ctas, device, stream
    "bjxa_loadstore_bound": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # bits, device
    "bjxa_loadstore_bound_occupancy": (_I, _I),
    # x, out, n, elem_bytes, mix, ctas, device, stream
    "bjxa_alu_mix": (_P, _P, _LL, _I, _I, _I, _I, _P),
    # elem_bytes, mix, device
    "bjxa_alu_mix_occupancy": (_I, _I, _I),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH)"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbjxa_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cu = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in cu]
    cmds = [
        [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(o), str(s)]
        for s, o in zip(cu, objs)
    ]
    # one nvcc per source, all started together
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    results = [(c, p.returncode, out, err)
               for c, p, (out, err) in zip(cmds, procs, outs)]
    if all(rc == 0 for _, rc, _, _ in results):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res.returncode, res.stdout, res.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + out + err for c, _, out, err in results
    ))
    failed = [(c, rc, err) for c, rc, _, err in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, err = failed[0]
        raise KernelBuildError(
            f"{os.path.basename(c[-1])}: nvcc failed ({rc}):\n{err[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never see a torn .so
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
