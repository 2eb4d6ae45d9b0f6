"""Large host copies split over a few threads.

One core of an H100 host copies at 6-7 GB/s: a 5-minute song's 52.9 MB
of PCM took 7.5-9.3 ms on one thread and 1.5-4.2 ms on four there
(``PERF.md`` §6).  ``numpy`` releases the interpreter lock while it
copies, so slices of one copy run side by side on a small pool of threads,
made on first use (and made again in a forked child, where the parent's
threads do not exist).  A copy is cut into more slices than there are
threads, so a thread held up on a busy core takes fewer of them.  Smaller
copies stay on the calling thread, where handing them over costs more
than it saves.

:func:`joined` builds a returned ``bytes`` image the same way: the new
object is made empty through the C API and its payload copied in slices,
so the image costs one copy of the payload, split like any other.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Threads a large copy is split over (at most the host's cores).
THREADS = min(4, os.cpu_count() or 1)
#: Slices a thread takes of a split copy, on average.
SLICES_PER_THREAD = 4
#: Bytes from which a copy is split: songs are, 15 s files (1.3-2.6 MB)
#: are not.
SPLIT_BYTES = 8 << 20

_pool: ThreadPoolExecutor | None = None
_pool_pid = 0
_pool_lock = threading.Lock()

# A new bytes object of a given size, its contents unset, and the address
# of its contents: the C API's way to fill one in place before anyone else
# holds it.  Own function objects, so the shared ``ctypes.pythonapi`` ones
# keep their signatures.
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def _executor() -> ThreadPoolExecutor:
    global _pool, _pool_pid
    with _pool_lock:
        if _pool is None or _pool_pid != os.getpid():
            _pool = ThreadPoolExecutor(THREADS,
                                       thread_name_prefix="bjxa-copy")
            _pool_pid = os.getpid()
        return _pool


def copy_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``np.copyto(dst, src)`` for arrays of one shape, in slices of the
    first axis (:data:`SLICES_PER_THREAD` a thread) over :data:`THREADS`
    threads where the copy is at least :data:`SPLIT_BYTES` long."""
    rows = dst.shape[0]
    if dst.nbytes < SPLIT_BYTES or THREADS < 2 or rows < THREADS:
        np.copyto(dst, src)
        return
    step = -(-rows // (THREADS * SLICES_PER_THREAD))
    done = _executor().map(
        lambda a: np.copyto(dst[a:a + step], src[a:a + step]),
        range(0, rows, step))
    for _ in done:  # raises here what a slice raised
        pass


def joined(head: bytes, body: np.ndarray) -> bytes:
    """``head + body.tobytes()`` as a new ``bytes`` object, with one copy
    of ``body`` (C-contiguous), split by :func:`copy_into` where it is
    large."""
    if body.nbytes < SPLIT_BYTES or THREADS < 2:
        return b"".join((head, body))
    n = len(head) + body.nbytes
    out = _new_bytes(None, n)
    dst = np.frombuffer((ctypes.c_char * n).from_address(_bytes_data(out)),
                        np.uint8)
    dst[: len(head)] = np.frombuffer(head, np.uint8)
    copy_into(dst[len(head):], body.reshape(-1).view(np.uint8))
    return out
