"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m xabench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run makes its inputs from the seed,
warms the program up on the cell's own shapes (``setup_s`` counts from the
process's start to here), measures for ``--seconds`` seconds, and judges
every answer of the window against the plain reference once the window has
closed.  It prints the numbers it compared, each beside its limit, as the
last lines of standard error, and one JSON line as the last line of
standard output: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics: those of the program's spans and of the clock from the
same window, those of the device from a second, shorter window traced by
``torch.profiler``.  Without enough CUDA devices it exits 2 and prints no
result; with JAX or the JAX package loaded, 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from xabench import drivers, spec  # noqa: E402
from xabench import trace as tr  # noqa: E402

#: Top-level module names that must not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "bjxa_tpu")
#: Seconds of the traced window of a ``--trace 1`` run (at most the
#: run's own window): its device numbers are shares, steady over a few
#: seconds, and every second of it writes as much as the window does.
TRACE_SECONDS = 5.0
#: The numbers compared and their limits: every comparison is exact.
LIMITS = {"outputs_missing": 0, "outputs_wrong": 0, "blocks_wrong": 0}


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec.Cell
    #: the measured window (untraced in every run)
    rec: drivers.Record
    setup_s: float
    #: the traced window of a ``--trace 1`` run, and its trace's summary
    traced: drivers.Record | None = None
    summary: dict | None = None


def _no_span(_name):
    return contextlib.nullcontext()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float = _T0) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    workdir = tempfile.mkdtemp(prefix="xabench-")
    try:
        drv = drivers.load(cell.traffic["driver"])(cell, seed, device,
                                                   workdir)
        drv.make_inputs()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        _settle_allocator()
        drv.warm()
        setup_s = time.perf_counter() - t0
        ctx = Context(cell, drv.window(seconds, _no_span), setup_s)
        _report_window(ctx.rec)
        if trace:
            with tr.profiled(True) as prof:
                with tr.span(tr.WINDOW):
                    ctx.traced = drv.window(min(seconds, TRACE_SECONDS),
                                            tr.span)
            ctx.summary = tr.summarize(prof)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.empty_cache()
        judge_from = time.perf_counter()
        checks = drv.judge()
        print(f"xabench: set-up {setup_s:.3f} s, judged in"
              f" {time.perf_counter() - judge_from:.3f} s", file=sys.stderr)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        got = setup_s if m["name"] == "setup_s" else spec.reader(
            m["name"])(ctx)
        if got is None:
            continue
        entry = got if isinstance(got, dict) else {"value": got}
        metrics[m["name"]] = {"value": entry.pop("value"), "unit": m["unit"],
                              **entry}
    attempted = ctx.rec.attempted + (ctx.traced.attempted if trace else 0)
    result = {
        # a window that made no request has shown nothing correct
        "correct": attempted > 0 and all(v <= LIMITS[k]
                                         for k, v in checks.items()),
        "attempted": attempted,
        "failed": checks["outputs_missing"] + checks["outputs_wrong"],
        "metrics": metrics,
        "device": _device(device, cell.chips, peak),
    }
    if trace:
        result["device"]["busy_s"] = ctx.summary["busy_s"]
        result["device"]["window_s"] = ctx.summary["window_s"]
        result["breakdown"] = ctx.summary["breakdown"]
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in checks.items()}
    return result


def _settle_allocator() -> None:
    """Put glibc's allocator in the state any process reaches once it has
    freed one large buffer: freeing a block that ``mmap`` served raises the
    size from which ``malloc`` maps fresh memory to that block's size (at
    most 32 MiB), so the program's per-call buffers of a few MiB come from
    the heap and are reused instead of mapped, faulted in and unmapped each
    call.  Left to chance, runs of ``wav_to_xa`` on the card's host came out
    in either state and differed by up to 2x."""
    import numpy as np

    block = np.ones(31 << 20, np.uint8)
    del block


def _report_window(rec) -> None:
    """One line on standard error of how the window went: the medians of
    its one-second slices (ms a call), or each pass's seconds."""
    if rec.lat_ms:
        t, slices, cur = 0.0, [], []
        for ms in rec.lat_ms:
            cur.append(ms)
            t += ms
            if t >= 1000:
                slices.append(statistics.median(cur))
                t, cur = 0.0, []
        shape = "ms a call by second " + " ".join(f"{m:.4f}" for m in slices)
    else:
        shape = "s a pass " + " ".join(f"{s:.3f}" for s in rec.pass_s)
    print(f"xabench: window {rec.elapsed_s:.3f} s, {shape}", file=sys.stderr)


def _device(device, count: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        info["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"xabench: {args.workload} needs {cell.chips} CUDA device(s),"
              " none here", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        print(f"xabench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
