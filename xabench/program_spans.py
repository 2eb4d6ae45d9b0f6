"""The program's own spans of a traced window.

Under ``--trace 1`` the traced window runs inside ``torch.profiler``, and
the program keeps a record of each of its spans
(``bjxa_tpu_torch.utils.profiler.span``): name, start and end in ns, its
parent's id, and the id of its request (the call's root span).  The
readers of the span metrics (``metrics/file_encode.*_ms.py`` and the
counts beside them) group those records by request here and take each
stage's duration a call.  A program that keeps no records (one older than
its spans, or a run without a trace) gives no call, and every reader None.
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def records() -> list:
    """The program's span records, or none where it keeps none."""
    try:
        from bjxa_tpu_torch.utils.profiler import records as kept
    except ImportError:
        return []
    return kept()


def dropped() -> int:
    """Records the program's full store did not keep (0 where it keeps
    none)."""
    try:
        from bjxa_tpu_torch.utils.profiler import dropped as lost
    except ImportError:
        return 0
    return lost()


class Call:
    """One request: its root span and every span under it."""

    def __init__(self, root: dict, spans: list):
        self.root, self.spans = root, spans

    def ms(self, names) -> float | None:
        """Milliseconds of the spans named in ``names``, summed; None where
        the call has none of them."""
        ns = [s["end_ns"] - s["start_ns"] for s in self.spans
              if s["name"] in names]
        return sum(ns) * 1e-6 if ns else None

    def unspanned_ms(self) -> float:
        """Milliseconds of the root not covered by its children."""
        r0, r1 = self.root["start_ns"], self.root["end_ns"]
        covered, t = 0, r0
        for s0, s1 in sorted((max(s["start_ns"], r0), min(s["end_ns"], r1))
                             for s in self.spans
                             if s["parent"] == self.root["id"]):
            if s1 > t:
                covered += s1 - max(s0, t)
                t = s1
        return (r1 - r0 - covered) * 1e-6


def calls(ctx, root: str) -> list:
    """The traced window's calls whose root span is named ``root``: the
    last ``ctx.traced.attempted`` such requests in the store (all of them
    where the run has no traced window), in the order they ended."""
    by_request = defaultdict(list)
    for rec in records():
        by_request[rec["request"]].append(rec)
    found = []
    for recs in by_request.values():
        top = next((r for r in recs if r["id"] == r["request"]), None)
        if top is not None and top["name"] == root:
            found.append(Call(top, [r for r in recs if r is not top]))
    found.sort(key=lambda c: c.root["end_ns"])
    traced = getattr(ctx, "traced", None)
    if traced is not None:
        found = found[len(found) - min(len(found), traced.attempted):]
    return found


def over_calls(ctx, root: str, per_call, stat=statistics.median):
    """``stat`` (the median, or another of :mod:`statistics`) over the
    window's ``root`` calls of ``per_call(call)`` (calls where it gives
    None left out), with the count of calls read and, where the store was
    full, the count of records it ``dropped`` (the window's last calls are
    then missing); None where there is none."""
    values = [v for v in map(per_call, calls(ctx, root)) if v is not None]
    if not values:
        return None
    out = {"value": stat(values), "calls": len(values)}
    lost = dropped()
    if lost:
        out["dropped"] = lost
    return out


def attr(call: Call, name: str, key: str):
    """The attribute ``key`` of the call's span ``name`` (its root, where
    ``name`` is the root's), or None."""
    for s in (call.root, *call.spans):
        if s["name"] == name and key in s["attrs"]:
            return s["attrs"][key]
    return None
