"""The traced window: ``torch.profiler`` around it, and what is read from
the trace.

Device activity is every kernel, copy and memset the trace shows in the
window, under whatever names they have.  ``kernel_s`` is the sum of the
kernels' durations (the rooflines' denominator).  ``window_s`` is the time
the program had requests in hand: the union of the harness's ranges
around its calls into the program (``xabench.<layer>.<entry>``), which
leaves out the harness's own work between requests; ``busy_s`` is the
union of the device's intervals within them.  The breakdown names the
device operations that took most time and the longest idle gaps within the
requests by the innermost host range that was open in the middle of each
(the harness's ranges, or the program's own operators).
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host ranges that say nothing of what the host was doing.
_NOT_WORK = ("ProfilerStep", "[memory]")


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over CPU and CUDA around the ``with`` body when
    ``enabled``; yields the profiler, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A named host range in the trace (a no-op when nothing traces)."""
    import torch

    return torch.profiler.record_function(name)


def _kind(e) -> str | None:
    """A device event's kind (one of :data:`DEVICE_KINDS`), or None for a
    host event or a device-side copy of a host range."""
    if not str(e.device_type()).endswith("CUDA"):
        return None
    kind = getattr(e, "activity_type", None)
    kind = kind() if callable(kind) else None
    if kind is not None:
        return kind if kind in DEVICE_KINDS else None
    if e.is_user_annotation() or e.name().startswith("xabench."):
        return None
    name = e.name().lower()
    return ("gpu_memcpy" if name.startswith("memcpy") else
            "gpu_memset" if name.startswith("memset") else "kernel")


def _events(prof):
    """``(device, host)`` lists of ``(start_s, end_s, name, kind)``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        item = (start, start + e.duration_ns() * 1e-9, e.name())
        kind = _kind(e)
        if kind is not None:
            device.append((*item, kind))
        elif (not str(e.device_type()).endswith("CUDA")
              and not e.name().startswith(_NOT_WORK)):
            host.append((*item, None))
    return device, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


#: The host range the harness opens around the whole traced window.
WINDOW = "xabench.window"


def _clip(intervals, spans):
    """The parts of ``intervals`` that lie within the sorted, disjoint
    ``spans``."""
    ends = [b for _, b in spans]
    out = []
    for s, e in intervals:
        i = bisect.bisect_right(ends, s)
        while i < len(spans) and spans[i][0] < e:
            a, b = spans[i]
            out.append((max(s, a), min(e, b)))
            i += 1
    return out


def summarize(prof) -> dict:
    """What the trace says of the window (the :data:`WINDOW` range).
    Returns ``kernel_s``, ``busy_s``, ``window_s``, ``kernels`` (seconds by
    kernel name) and ``breakdown``."""
    return _summary(*_events(prof))


def _summary(device, host) -> dict:
    """:func:`summarize` of the ``(device, host)`` lists of
    :func:`_events`."""
    w0, w1 = next((s, e) for s, e, n, _ in host if n == WINDOW)
    device = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in device
              if e > w0 and s < w1]
    requests = _union(_clip(
        [(s, e) for s, e, n, _ in host
         if n.startswith("xabench.") and n != WINDOW], [(w0, w1)]))
    by_name = defaultdict(float)
    kernels = defaultdict(float)
    for s, e, n, k in device:
        by_name[n] += e - s
        if k == "kernel":
            kernels[n] += e - s
    busy = _union(_clip([(s, e) for s, e, _, _ in device], requests))
    gaps, j = [], 0
    for a, b in requests:  # each busy interval lies within one request
        t = a
        while j < len(busy) and busy[j][0] < b:
            if busy[j][0] > t:
                gaps.append((t, busy[j][0]))
            t = busy[j][1]
            j += 1
        if t < b:
            gaps.append((t, b))
    idle = defaultdict(float)
    for (g0, g1), label in zip(gaps, _labels(gaps, host)):
        idle[label] += g1 - g0
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {
        "kernel_s": sum(kernels.values()),
        "busy_s": sum(e - s for s, e in busy),
        "window_s": sum(b - a for a, b in requests),
        "kernels": dict(kernels),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }


def _labels(gaps, host):
    """For each gap (in time order), the innermost host range open at its
    middle: the one that started last among those still open."""
    host = sorted(host)
    heap, i, out = [], 0, []
    for g0, g1 in gaps:
        m = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= m:
            s, e, n, _ = host[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] <= m:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host outside any traced range")
    return out
