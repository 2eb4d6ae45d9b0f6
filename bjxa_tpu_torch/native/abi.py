"""Build, load and install the drop-in C ABI library (``bjxa_abi.cc``).

Port of :mod:`bjxa_tpu.native.abi`, on this package's own copy of the
sources.  The reference ships ``libbjxa.so`` with 19 versioned symbols, a
public header and a pkg-config file (reference ``src/libbjxa.map``,
``src/bjxa.h``, ``bjxa.pc.in``); this module is its analog:

* :func:`lib` compiles ``libbjxa.so`` on demand (version-script link,
  same symbol version nodes, soname ``libbjxa.so.0``) and loads it via
  ctypes with full argtype annotations and ``use_errno`` so tests can
  assert the errno contract;
* :func:`cli_path` builds the C ``bjxa`` CLI (``bjxa_cli.c``) against it;
* :func:`install` copies the built library, the public ``bjxa.h``, a
  generated ``bjxa.pc`` and the CLI into a prefix, giving C users the
  reference's ``make install`` experience (``cc $(pkg-config --cflags
  --libs bjxa)``).

As for the host runtime (:mod:`bjxa_tpu_torch.native`), ``BJXA_NO_NATIVE``
turns the library off (:func:`lib` returns None) and a failed build raises
:class:`~bjxa_tpu_torch.native.NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading

from bjxa_tpu_torch.native import (
    CXXFLAGS,
    disabled,
    run_compiler,
    stale,
)

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "bjxa_abi.cc"
_CORE = _HERE / "xa_core.h"
_HEADER = _HERE / "include" / "bjxa.h"
_MAP = _HERE / "libbjxa.map"
_CLI_SRC = _HERE / "bjxa_cli.c"
_BUILD_DIR = _HERE / "_build"
_SO = _BUILD_DIR / "libbjxa.so"
_SONAME = _BUILD_DIR / "libbjxa.so.0"
_CLI = _BUILD_DIR / "bjxa"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compile_command() -> list[str]:
    """The compiler command of ``libbjxa.so`` (``-o`` is added)."""
    return [
        os.environ.get("CXX", "g++"),
        *CXXFLAGS,
        f"-Wl,--version-script={_MAP}",
        "-Wl,-soname,libbjxa.so.0",
        str(_SRC),
    ]


def cli_command() -> list[str]:
    """The compiler command of the C CLI (``-o`` is added)."""
    return [
        os.environ.get("CC", "cc"),
        "-O2",
        f"-I{_HEADER.parent}",
        str(_CLI_SRC),
        f"-L{_BUILD_DIR}",
        "-lbjxa",
        "-Wl,-rpath,$ORIGIN",
        "-Wl,-rpath,$ORIGIN/../lib",
    ]


def build() -> pathlib.Path:
    """Compile ``libbjxa.so`` if it is missing or stale; its path."""
    if stale(_SO, (_SRC, _CORE, _HEADER, _MAP)):
        run_compiler(compile_command(), _SO)
    return _SO


def _annotate(cdll: ctypes.CDLL) -> None:
    """Declare restype/argtypes for the full 21-symbol surface."""
    voidp = ctypes.c_void_p
    size_t = ctypes.c_size_t
    ssize_t = ctypes.c_ssize_t
    filep = ctypes.c_void_p  # FILE* handled as an opaque pointer

    decoder = [
        ("bjxa_decoder", voidp, []),
        ("bjxa_free_decoder", ctypes.c_int, [ctypes.POINTER(voidp)]),
        ("bjxa_parse_header", ssize_t, [voidp, voidp, size_t]),
        ("bjxa_fread_header", ssize_t, [voidp, filep]),
        ("bjxa_decode_format", ctypes.c_int, [voidp, voidp]),
        ("bjxa_decode", ctypes.c_int, [voidp, voidp, size_t, voidp, size_t]),
        ("bjxa_dump_riff_header", ssize_t, [voidp, voidp, size_t]),
        ("bjxa_fwrite_riff_header", ssize_t, [voidp, filep]),
        ("bjxa_dump_pcm", ctypes.c_int, [voidp, voidp, size_t]),
        ("bjxa_fwrite_pcm", ctypes.c_int, [voidp, size_t, filep]),
    ]
    encoder = [
        ("bjxa_encoder", voidp, []),
        ("bjxa_free_encoder", ctypes.c_int, [ctypes.POINTER(voidp)]),
        ("bjxa_encode_init", ctypes.c_int, [voidp, voidp, ctypes.c_uint8]),
        ("bjxa_parse_riff_header", ssize_t, [voidp, voidp, size_t]),
        ("bjxa_fread_riff_header", ssize_t, [voidp, filep]),
        ("bjxa_encode_format", ctypes.c_int, [voidp, voidp]),
        ("bjxa_encode", ctypes.c_int, [voidp, voidp, size_t, voidp, size_t]),
        ("bjxa_dump_header", ssize_t, [voidp, voidp, size_t]),
        ("bjxa_fwrite_header", ssize_t, [voidp, filep]),
    ]
    extensions = [
        ("bjxa_tpu_encode_search", ctypes.c_int, [voidp, ctypes.c_int]),
        ("bjxa_tpu_version", ctypes.c_char_p, []),
    ]
    for name, restype, argtypes in decoder + encoder + extensions:
        fn = getattr(cdll, name)
        fn.restype = restype
        fn.argtypes = argtypes


class CFormat(ctypes.Structure):
    """ctypes mirror of the public ``bjxa_format_t`` value struct."""

    _fields_ = [
        ("data_len_pcm", ctypes.c_uint32),
        ("blocks", ctypes.c_uint32),
        ("block_size_pcm", ctypes.c_uint8),
        ("block_size_xa", ctypes.c_uint8),
        ("samples_rate", ctypes.c_uint16),
        ("sample_bits", ctypes.c_uint8),
        ("channels", ctypes.c_uint8),
    ]


def so_path() -> pathlib.Path:
    """Path of the built library (it may not exist yet; see :func:`lib`)."""
    return _SO


def cli_path() -> pathlib.Path | None:
    """Build (if needed) and return the native ``bjxa`` CLI binary.

    The binary is plain C compiled against the public header and linked
    against libbjxa.so with ``$ORIGIN``-relative rpaths, so it runs both
    from the build dir and from an installed ``<prefix>/bin``.  Returns
    None when ``BJXA_NO_NATIVE`` turns the library off; a failed build
    raises.
    """
    if lib() is None:
        return None
    with _lock:
        if not stale(_CLI, (_CLI_SRC, _HEADER, _SO)):
            return _CLI
        # the dynamic loader resolves the soname, not the -l name
        tmp = _SONAME.with_name(f".{_SONAME.name}.{os.getpid()}.tmp")
        tmp.write_bytes(_SO.read_bytes())
        os.replace(tmp, _SONAME)
        run_compiler(cli_command(), _CLI)
        return _CLI


def lib() -> ctypes.CDLL | None:
    """Load (building if needed) libbjxa.so; None when ``BJXA_NO_NATIVE``
    turns it off.  A failed build raises."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        cdll = ctypes.CDLL(str(build()), use_errno=True)
        _annotate(cdll)
        version = cdll.bjxa_tpu_version()
        if version != b"0.5.0":
            raise RuntimeError(f"{_SO}: version {version!r}, want 0.5.0")
        _lib = cdll
        return _lib


def available() -> bool:
    return lib() is not None


_PKGCONFIG = """\
prefix={prefix}
exec_prefix=${{prefix}}
libdir=${{exec_prefix}}/lib
includedir=${{prefix}}/include

Name: bjxa
Description: BandJAM XA audio codec (bjxa-tpu native engine)
Version: {version}
Libs: -L${{libdir}} -lbjxa
Cflags: -I${{includedir}}
"""


def install(prefix: str | os.PathLike) -> dict[str, pathlib.Path]:
    """Install the library, header, pkg-config file and CLI under
    ``prefix``.

    Creates ``lib/libbjxa.so.0`` (+ a ``libbjxa.so`` symlink to it),
    ``include/bjxa.h``, ``lib/pkgconfig/bjxa.pc`` and ``bin/bjxa``.
    Returns the installed paths keyed by role.  Raises RuntimeError if the
    library is off or cannot be built.
    """
    cdll = lib()
    if cdll is None:
        raise RuntimeError("C ABI library unavailable (BJXA_NO_NATIVE is"
                           " set)")
    prefix = pathlib.Path(prefix)
    libdir = prefix / "lib"
    incdir = prefix / "include"
    pcdir = libdir / "pkgconfig"
    for d in (libdir, incdir, pcdir):
        d.mkdir(parents=True, exist_ok=True)

    so = libdir / "libbjxa.so.0"
    so.write_bytes(_SO.read_bytes())
    link = libdir / "libbjxa.so"
    if link.exists() or link.is_symlink():
        link.unlink()
    link.symlink_to(so.name)

    header = incdir / "bjxa.h"
    header.write_bytes(_HEADER.read_bytes())

    version = cdll.bjxa_tpu_version().decode()
    pc = pcdir / "bjxa.pc"
    pc.write_text(_PKGCONFIG.format(prefix=prefix, version=version))
    out = {"lib": so, "link": link, "header": header, "pkgconfig": pc}

    bindir = prefix / "bin"
    bindir.mkdir(parents=True, exist_ok=True)
    exe = bindir / "bjxa"
    exe.write_bytes(cli_path().read_bytes())
    exe.chmod(0o755)
    out["bin"] = exe
    return out
