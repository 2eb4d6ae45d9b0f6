"""Allocator hygiene for long-lived processes.

Port of :mod:`bjxa_tpu.utils.hygiene`.  The JAX package drops compiled
executables and memoized shard_map wrappers there; this package compiles
nothing per shape (its kernels are one library, built once), so what a
long-running process holds on to is memory: Python garbage, the CUDA
caching allocator's free blocks and glibc's retained arena pages.
:func:`clear_compiled_caches` releases all three.  Safe at any quiescent
point: results are unaffected.
"""

from __future__ import annotations

import ctypes
import gc

import torch


def clear_compiled_caches(trim_malloc: bool = True) -> None:
    """Collect garbage, return the CUDA caching allocator's free blocks
    to the driver (only where this process has already initialised CUDA:
    it never initialises it), and on glibc return freed arena pages to the
    kernel.

    Args:
      trim_malloc: also call ``malloc_trim(0)`` where available, so the
        allocator unmaps retention pages after large transient buffers
        are freed.
    """
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    if trim_malloc:
        try:
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except (OSError, AttributeError):  # not glibc
            pass
