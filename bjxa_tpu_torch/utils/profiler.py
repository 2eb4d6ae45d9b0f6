"""Profiling hooks: torch.profiler traces + throughput counters.

The reference has no instrumentation at all (SURVEY §5); here the corpus
engine reports samples/sec and files/sec and the time of each of its
stages, and can capture a trace of the host and the device for a trace
viewer when asked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time


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
        """Add the host time of the ``with`` body to ``stage``."""
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

    With a ``trace_dir``, :meth:`trace` records the host's operators and,
    where a CUDA device is present, its kernels and copies, then writes a
    Chrome trace (``chrome://tracing``, Perfetto) to
    ``<trace_dir>/bjxa-trace.json``.
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
        with profile(activities=activities) as prof:
            yield self
        prof.export_chrome_trace(os.path.join(self.trace_dir, TRACE_FILE))
