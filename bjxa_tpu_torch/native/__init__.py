"""ctypes bindings for the native host runtime (``bjxa_host.cc``).

Port of :mod:`bjxa_tpu.native`, with its own copy of the C++ sources.  The
shared library is compiled on demand with the system C++ compiler the first
time it is needed (and again whenever a source is newer), into
``_build/`` beside this file, then loaded via ctypes.

There is no silent fallback: ``BJXA_NO_NATIVE`` (any non-empty value)
turns the library off, and then :func:`lib` returns None and the callers
take their numpy paths; a compiler that is missing or fails raises
:class:`NativeBuildError` with its stderr.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "bjxa_host.cc"
_CORE = _HERE / "xa_core.h"
_BUILD_DIR = _HERE / "_build"
_SO = _BUILD_DIR / "libbjxa_host.so"

#: Compiler flags of both native libraries (``abi.py`` adds its link flags).
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The native compiler is missing or refused a source."""


def disabled() -> bool:
    """True when ``BJXA_NO_NATIVE`` turns the native libraries off."""
    return bool(os.environ.get("BJXA_NO_NATIVE"))


def stale(out: pathlib.Path, sources) -> bool:
    """True when ``out`` is missing or older than any of ``sources``."""
    if not out.exists():
        return True
    return out.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def run_compiler(cmd: list[str], out: pathlib.Path) -> None:
    """Run ``cmd + ["-o", tmp]`` and move ``tmp`` onto ``out``.

    ``tmp`` is named for this process and thread, so concurrent builds
    (test workers, say) never write one file; the move is atomic.  Raises
    :class:`NativeBuildError` with the compiler's stderr if it is missing
    or fails.
    """
    out.parent.mkdir(exist_ok=True)
    tmp = out.with_name(
        f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    full = [*cmd, "-o", str(tmp)]
    try:
        res = subprocess.run(full, capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"{full[0]}: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{' '.join(full)} exited {res.returncode}:\n{res.stderr}")
    os.replace(tmp, out)


def compile_command() -> list[str]:
    """The compiler command of the host library (``-o`` is added)."""
    return [os.environ.get("CXX", "g++"), *CXXFLAGS, str(_SRC)]


def build() -> pathlib.Path:
    """Compile the host library if it is missing or stale; its path."""
    if stale(_SO, (_SRC, _CORE)):
        run_compiler(compile_command(), _SO)
    return _SO


def lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None when
    ``BJXA_NO_NATIVE`` turns it off.  A failed build raises."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        cdll = ctypes.CDLL(str(build()))

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u32 = ctypes.c_uint32

        cdll.bjxa_host_decode_blocks.restype = ctypes.c_int
        cdll.bjxa_host_decode_blocks.argtypes = [
            u8p, u32, u32, u32, i32p, i16p, u32p,
        ]
        cdll.bjxa_host_encode_truncate.restype = ctypes.c_int
        cdll.bjxa_host_encode_truncate.argtypes = [i16p, u32, u32, u32, u8p]
        cdll.bjxa_host_encode_search.restype = ctypes.c_int
        cdll.bjxa_host_encode_search.argtypes = [
            i16p, u32, u32, u32, i32p, u8p,
        ]
        cdll.bjxa_host_abi_version.restype = ctypes.c_uint32
        if cdll.bjxa_host_abi_version() != 1:
            raise NativeBuildError(
                f"{_SO}: host ABI version {cdll.bjxa_host_abi_version()},"
                " want 1")
        _lib = cdll
        return _lib


def available() -> bool:
    return lib() is not None


def _loaded() -> ctypes.CDLL:
    cdll = lib()
    if cdll is None:
        raise RuntimeError("the native library is off (BJXA_NO_NATIVE)")
    return cdll


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_state(state: np.ndarray, channels: int) -> None:
    if (state.dtype != np.int32 or not state.flags.c_contiguous
            or state.shape != (channels, 2)):
        raise ValueError(
            f"state must be C-contiguous int32[{channels}, 2], got"
            f" {state.dtype}{list(state.shape)}")


def decode_blocks(
    blocks: np.ndarray, bits: int, state: np.ndarray
) -> tuple[np.ndarray, int]:
    """Decode ``uint8[nblocks, channels, block_size]`` effective blocks.

    ``state`` (``int32[channels, 2]``) is updated in place.  Returns
    ``(int16[nblocks*32, channels], blocks_done)``; ``blocks_done`` is less
    than ``nblocks`` iff an invalid profile stopped the stream.
    """
    cdll = _loaded()
    nblocks, channels, size = blocks.shape
    if size != 4 * bits + 1:
        raise ValueError(f"block size {size} != 4*{bits}+1")
    _check_state(state, channels)
    blocks = np.ascontiguousarray(blocks, np.uint8)
    pcm = np.empty((nblocks * 32, channels), np.int16)
    done = ctypes.c_uint32(0)
    rc = cdll.bjxa_host_decode_blocks(
        _as_ptr(blocks, ctypes.c_uint8),
        nblocks,
        channels,
        bits,
        _as_ptr(state, ctypes.c_int32),
        _as_ptr(pcm, ctypes.c_int16),
        ctypes.byref(done),
    )
    if rc not in (0, -71):  # 0 | -EPROTO
        raise RuntimeError(f"bjxa_host_decode_blocks failed: {rc}")
    return pcm, int(done.value) if rc else nblocks


def encode_blocks(
    pcm: np.ndarray, bits: int, state: np.ndarray, *, search: bool
) -> np.ndarray:
    """Encode zero-padded ``int16[nblocks*32, channels]`` PCM to raw blocks
    ``uint8[nblocks, channels, block_size]``; updates ``state`` in place
    when searching."""
    cdll = _loaded()
    frames, channels = pcm.shape
    if frames % 32:
        raise ValueError(f"{frames} frames is not a whole number of blocks")
    nblocks = frames // 32
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty((nblocks, channels, bits * 4 + 1), np.uint8)
    if search:
        _check_state(state, channels)
        rc = cdll.bjxa_host_encode_search(
            _as_ptr(pcm, ctypes.c_int16),
            nblocks,
            channels,
            bits,
            _as_ptr(state, ctypes.c_int32),
            _as_ptr(out, ctypes.c_uint8),
        )
    else:
        rc = cdll.bjxa_host_encode_truncate(
            _as_ptr(pcm, ctypes.c_int16),
            nblocks,
            channels,
            bits,
            _as_ptr(out, ctypes.c_uint8),
        )
    if rc != 0:
        raise RuntimeError(f"bjxa_host_encode failed: {rc}")
    return out
