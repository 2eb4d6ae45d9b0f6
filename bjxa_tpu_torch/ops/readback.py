"""Device->host readback that does not block the host: a copy into pinned
memory behind a CUDA event.  Shared by the corpus engine's batches and the
segmented decode's segments, which both fetch one result while the next
piece of work is staged."""

from __future__ import annotations

import numpy as np
import torch


def mark(device: torch.device):
    """A timing CUDA event recorded now on ``device``'s current stream;
    ``None`` for the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def start_readback(t: torch.Tensor):
    """Begin the device->host copy of ``t`` now, without blocking.

    Returns ``(host, event)``: a pinned host tensor the copy lands in and
    the CUDA event that fires once it has; ``(t, None)`` for a CPU tensor.
    """
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, mark(t.device)


def finish_readback(host: torch.Tensor, landed) -> np.ndarray:
    """Wait for a copy begun by :func:`start_readback` and return its
    bytes as a numpy array that any thread may own.

    A non-blocking copy into pinned memory that is read before its event
    has fired gives stale bytes and no error, hence the wait.  The result
    is a pageable copy: freeing a pinned block records CUDA events, so
    pinned buffers are released here, on the thread that started the
    copies, and a consumer on another thread makes no CUDA calls.
    """
    if landed is None:
        return host.numpy()
    landed.synchronize()
    return host.numpy().copy()
