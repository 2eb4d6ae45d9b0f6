"""What the measurement scripts share: the device they run on and its
label, the timing loop, environment integers and seeded inputs."""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import threading
import time

import torch


class NoDeviceError(RuntimeError):
    """No CUDA card, and the CPU was not asked for."""


def bench_device() -> torch.device:
    """The device a measurement runs on: the CUDA card, or the CPU when
    ``BJXA_PLATFORM=cpu`` (the CLI's rule).  Without a card and without the
    variable it raises: a measurement never moves to the CPU on its own."""
    if os.environ.get("BJXA_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "CUDA is not available; set BJXA_PLATFORM=cpu to rehearse on"
            " the CPU"
        )
    return torch.device("cuda")


@functools.cache
def device_label(device: torch.device) -> str:
    """``"<card name>, <power limit>"`` as ``nvidia-smi`` reports them (a
    card below its full limit runs slower, so every number carries it);
    ``"cpu"`` for the CPU."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return f"{name}, power limit unknown"
    return res.stdout.strip().splitlines()[0]


class PeakRss:
    """Peak resident set of a process while the ``with`` block runs, in MB
    (``peak_mb``): ``VmRSS`` of ``/proc/<pid>/status``, sampled every few
    milliseconds by a thread.  ``pid`` defaults to this process.

    Sampled, not read from ``ru_maxrss`` or ``VmHWM``: a child process
    starts those from its parent's peak (``ru_maxrss`` on Linux, both in
    some sandboxes), which hides a small child behind a large parent.
    """

    def __init__(self, pid: int | None = None, interval: float = 0.005):
        self._status = f"/proc/{os.getpid() if pid is None else pid}/status"
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.peak_mb = 0.0

    def _sample(self) -> None:
        try:
            with open(self._status) as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.peak_mb = max(self.peak_mb,
                                           int(line.split()[1]) / 1024)
                        return
        except OSError:  # the process is gone
            pass

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()
        return False


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def time_ms(fn, device: torch.device, *, reps: int, inner: int = 8) -> float:
    """Median milliseconds of one ``fn()`` over ``reps`` timed windows of
    ``inner`` calls each, after one warm-up window: CUDA events on a card,
    the host clock on the CPU."""
    for _ in range(inner):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / inner)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def emit(record: dict, device: torch.device) -> dict:
    """Print ``record`` as one JSON line with ``"device"`` added."""
    record = dict(record, device=device_label(device))
    print(json.dumps(record), flush=True)
    return record


def random_lanes(seed: int, blocks: int, lanes: int, bits: int,
                 device: torch.device) -> torch.Tensor:
    """Seeded raw lane-major blocks ``uint8[B, 4*bits+1, L]`` made on
    ``device``: random payload, valid profiles (factor 0-4, range 0-15)."""
    g = torch.Generator(device=device).manual_seed(seed)
    size = 4 * bits + 1
    blocks_t = torch.randint(0, 256, (blocks, size, lanes), generator=g,
                             device=device, dtype=torch.uint8)
    factor = torch.randint(0, 5, (blocks, lanes), generator=g, device=device)
    shift = torch.randint(0, 16, (blocks, lanes), generator=g, device=device)
    blocks_t[:, 0, :] = (factor << 4 | shift).to(torch.uint8)
    return blocks_t
