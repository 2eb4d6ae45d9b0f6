"""What the metrics' readers (``metrics/<name>.py``) share.

Each function takes the run's :class:`xabench.run.Context` and returns the
number, or None where the run has nothing to read.  Which cells report a
metric is ``BENCHMARK.json``'s to say (its ``workloads``), not a reader's.
"""

from __future__ import annotations

import statistics

from xabench import work


def latency_ms(ctx, q: int):
    """The ``q``-th percentile of every call's latency in the window
    (``statistics.quantiles``, 100 cut points, inclusive)."""
    if len(ctx.rec.lat_ms) < 2:
        return None
    return statistics.quantiles(ctx.rec.lat_ms, n=100,
                                method="inclusive")[q - 1]


def roofline(ctx, direction: str):
    """The least time the traced window's ``direction`` work needs on the
    card (bytes over the memory rate or operations over the integer rate,
    whichever is larger; :mod:`xabench.work`), as a percentage of all the
    kernel time the trace shows in that window."""
    if ctx.summary is None or ctx.summary["kernel_s"] <= 0:
        return None
    count = work.encode_work if direction == "encode" else work.decode_work
    least, bound = work.least_time(*count(ctx.traced.done))
    return {"value": 100 * least / ctx.summary["kernel_s"], "bound": bound}


def idle_share(ctx):
    """The share of the traced window in which no kernel, copy or memset
    ran on the card."""
    if ctx.summary is None or ctx.summary["busy_s"] <= 0:
        return None
    return 100 * (1 - ctx.summary["busy_s"] / ctx.summary["window_s"])
