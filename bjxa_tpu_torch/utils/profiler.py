"""Profiling hooks: torch.profiler traces, program spans, throughput
counters.

The reference has no instrumentation at all (SURVEY §5); here the corpus
engine reports samples/sec and files/sec and the time of each of its
stages, and can capture a trace of the host and the device for a trace
viewer when asked.  :func:`span` names a stage of the program in that
trace and keeps a record of it in memory (:func:`records`), on exactly
while a ``torch.profiler`` session records and a null context otherwise;
:func:`minor_faults` counts the page faults a span's work took.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import resource
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: Most records the span store keeps; later ones are counted by
#: :func:`dropped` and not kept.
MAX_RECORDS = 1_000_000

_store: list = []
_dropped = 0
_store_lock = threading.Lock()
_ids = itertools.count(1)

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a ``torch.profiler`` session records in this process
        (the CLI's ``--trace``, any caller's ``torch.profiler.profile``):
        spans are on exactly then."""
        return _autograd_profiler._is_profiler_enabled
else:  # a torch without the module's flag
    recording = torch._C._autograd._profiler_enabled

#: What a recording span opens: a named range among the profiler's host
#: events (``torch.profiler.record_function`` where torch lacks the
#: cheaper form, which costs an eighth as much).
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _NullSpan:
    """The span when nothing records: enters, sets and records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


#: What :func:`span` returns when nothing records: one shared object.
NULL_SPAN = _NullSpan()


class _Thread(threading.local):
    """A thread's open spans, the records of its open request that hold
    tensors, and its id (read once: a system call)."""

    def __init__(self):
        self.stack = []
        self.pending = []
        self.tid = threading.get_native_id()


_thread = _Thread()


class _Span:
    """A recording span: a range in the trace and one record in the store
    (see :func:`span`)."""

    __slots__ = ("rec", "_range")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}
        if attrs:
            _hold_tensors(self.rec, attrs)

    def set(self, **attrs) -> None:
        """Add attributes to the span's record."""
        self.rec["attrs"].update(attrs)
        _hold_tensors(self.rec, attrs)

    # The interval lies inside the span's range, so a stage's time leaves
    # out the cost of opening and closing it, and a root's the reads of
    # its request's tensor attributes.
    def __enter__(self):
        self._range = _Range(self.rec["name"])
        self._range.__enter__()
        rec = self.rec
        th = _thread
        stack = th.stack
        rec["id"] = sid = next(_ids)
        rec["thread"] = th.tid
        if stack:
            rec["parent"], rec["request"] = stack[-1]["id"], stack[0]["id"]
        else:  # a request's root
            rec["parent"], rec["request"] = None, sid
        stack.append(rec)
        rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.time_ns()
        th = _thread
        try:
            th.stack.pop()
            if not th.stack and th.pending:  # the call's readback has synced
                _read_tensors(th.pending, failed=exc[0] is not None)
        finally:
            try:
                self._range.__exit__(*exc)
            finally:
                _keep(rec)
        return False


def _read_tensors(pending: list, failed: bool) -> None:
    """Replace each tensor attribute of the ``pending`` records by its
    value (by None where the request failed: its work may never have run),
    and empty ``pending``."""
    try:
        for r in pending:
            r["attrs"] = {k: (None if failed else v.item())
                          if isinstance(v, torch.Tensor) else v
                          for k, v in r["attrs"].items()}
    finally:
        pending.clear()


def _hold_tensors(rec: dict, attrs: dict) -> None:
    """Note ``rec`` for its request's root to read where ``attrs`` holds a
    tensor."""
    for v in attrs.values():
        if isinstance(v, torch.Tensor):
            _thread.pending.append(rec)
            return


def _keep(rec: dict) -> None:
    global _dropped
    with _store_lock:
        if len(_store) < MAX_RECORDS:
            _store.append(rec)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A named stage of the program, as a context manager.

    While a ``torch.profiler`` session records (:func:`recording`), it opens
    a range named ``name`` among the profiler's host events, so the stage
    lies in the trace beside the device's kernels and copies, and keeps one
    record in the process's store (:func:`records`): ``name``,
    ``start_ns`` and ``end_ns`` on the clock of the profiler's host events
    (``time.time_ns``), taken inside the range, ``id``, ``parent`` (the
    span open around it on its thread, or None), ``request`` (the id of
    the outermost span open on its thread: one a call), ``thread`` and
    ``attrs``.  ``set(**attrs)`` adds attributes to the record.  An
    attribute that is a tensor is read with one ``.item()`` when its
    request's root span closes, after the root's ``end_ns``.

    Otherwise it returns :data:`NULL_SPAN`, which is false and does
    nothing: one check of the profiler's flag a span.
    """
    if not recording():
        return NULL_SPAN
    return _Span(name, attrs)


def records() -> list:
    """The records of every span closed since :func:`clear` (at most
    :data:`MAX_RECORDS`), children before their parents."""
    with _store_lock:
        return list(_store)


def dropped() -> int:
    """Records not kept since :func:`clear`: the store was full."""
    return _dropped


def clear() -> None:
    """Empty the span store."""
    global _dropped
    with _store_lock:
        _store.clear()
        _dropped = 0


_RUSAGE_THREAD = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)


def minor_faults() -> int:
    """Minor page faults the calling thread has taken so far
    (``getrusage(RUSAGE_THREAD).ru_minflt``; the process's where the
    system has no per-thread count): the difference over a call counts the
    fresh pages its buffers faulted in.  Under a kernel that counts no
    faults (gVisor's, for one) it reads 0 throughout."""
    return resource.getrusage(_RUSAGE_THREAD).ru_minflt


@dataclasses.dataclass
class Counters:
    """Monotonic throughput counters."""

    files: int = 0
    blocks: int = 0
    samples: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    frozen_s: float | None = None
    #: Milliseconds per stage of a corpus run, summed over its batches:
    #: host spans on the clock of the thread that ran them (``write`` runs
    #: on the writer thread, beside the others), device spans (``h2d``,
    #: ``compute``, ``d2h``) by CUDA events.
    stage_ms: dict = dataclasses.field(default_factory=dict)

    def add_ms(self, stage: str, ms: float) -> None:
        self.stage_ms[stage] = self.stage_ms.get(stage, 0.0) + ms

    @contextlib.contextmanager
    def span(self, stage: str):
        """Add the host time of the ``with`` body to ``stage``; in a trace,
        the body is the span ``bjxa.corpus.<stage>``."""
        with span(f"bjxa.corpus.{stage}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add_ms(stage, (time.perf_counter() - t0) * 1e3)

    def freeze(self) -> "Counters":
        """Stop the clock: rates computed later report the span up to now.

        The corpus engine freezes its counters when conversion finishes so
        post-run work (host-side printing) cannot inflate the reported
        elapsed.
        """
        self.frozen_s = self.elapsed()
        return self

    def elapsed(self) -> float:
        if self.frozen_s is not None:
            return self.frozen_s
        return max(time.perf_counter() - self.started_at, 1e-9)

    def rates(self) -> dict:
        dt = self.elapsed()
        return {
            "files_per_s": self.files / dt,
            "msamples_per_s": self.samples / dt / 1e6,
            "mb_in_per_s": self.bytes_in / dt / 1e6,
            "mb_out_per_s": self.bytes_out / dt / 1e6,
            "elapsed_s": dt,
        }


#: File name of the Chrome trace that :meth:`Profiler.trace` writes.
TRACE_FILE = "bjxa-trace.json"


class Profiler:
    """Optional torch.profiler trace around a region of work.

    With a ``trace_dir``, :meth:`trace` records the host's operators, the
    program's own ``bjxa.*`` ranges (:func:`span`) and, where a CUDA device
    is present, its kernels and copies, then writes a Chrome trace
    (``chrome://tracing``, Perfetto) to ``<trace_dir>/bjxa-trace.json``.
    It empties the span store on entry, so :func:`records` afterwards holds
    the spans of the traced region.
    """

    def __init__(self, trace_dir: str | None = None):
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def trace(self):
        if not self.trace_dir:
            yield self
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        clear()
        with profile(activities=activities) as prof:
            yield self
        prof.export_chrome_trace(os.path.join(self.trace_dir, TRACE_FILE))
