"""The general drivers of traffic mixes, one module a kind (a mix's
``driver`` key): ``corpus`` (passes of a corpus job over a directory) and
``file`` (one client calling the one-shot API in a closed loop).

A driver is built as ``Driver(cell, seed, device, workdir)`` and offers
``make_inputs()``, ``warm()``, ``window(seconds, span) -> Record`` and
``judge() -> dict``; the harness calls them in that
order.
"""

from __future__ import annotations

import dataclasses
import importlib

from xabench import reference as ref


@dataclasses.dataclass
class Record:
    """What one window did, on the harness's clock."""

    #: seconds of the window: from the first call's start to the last
    #: one's end (file), the sum of the passes' own (corpus)
    elapsed_s: float = 0.0
    #: requests made: files of every pass, or calls
    attempted: int = 0
    #: the input files each request handled, for the work counts
    done: list = dataclasses.field(default_factory=list)
    #: frames x channels of every request
    samples: int = 0
    #: each call's latency (file driver)
    lat_ms: list = dataclasses.field(default_factory=list)
    #: the program's ``Counters.stage_ms``, summed over passes (corpus)
    stage_ms: dict = dataclasses.field(default_factory=dict)
    passes: int = 0
    #: each pass's seconds (corpus)
    pass_s: list = dataclasses.field(default_factory=list)


def load(name: str):
    """The driver class of a traffic mix's ``driver`` key."""
    return importlib.import_module(f"xabench.drivers.{name}").Driver


def keep(answers: dict, i: int, data: bytes) -> None:
    """Count ``data`` among the distinct answers kept for input ``i``
    (``answers[i]``: ``[[bytes, count], ...]``), comparing byte for byte:
    the cheapest exact record between requests."""
    kept = answers.setdefault(i, [])
    for seen in kept:
        if seen[0] == data:
            seen[1] += 1
            return
    kept.append([data, 1])


def judge(drv, missing: int) -> dict:
    """The checks of a window: ``missing`` requests without an answer, and
    every distinct answer of ``drv.answers`` judged once against the
    reference (an encoded one block by block), counted as often as it came.
    """
    dev = drv.device
    used = sorted(drv.answers)
    keys = [(i, k) for i in used for k in range(len(drv.answers[i]))]
    out = [drv.answers[i][k] for i, k in keys]
    checks = {"outputs_missing": missing}
    if drv.encode:
        wrong = ref.judge_encoded(
            [o[0] for o in out], [drv.pcms[i].to(dev) for i, _ in keys],
            [drv.specs[i].rate for i, _ in keys], drv.traffic["bits"])
        checks["outputs_wrong"] = sum(o[1] for o, w in zip(out, wrong) if w)
        checks["blocks_wrong"] = sum(wrong)
        return checks
    want = dict(zip(used, ref.xa_to_wav_many([drv.images[i] for i in used],
                                             dev)))
    checks["outputs_wrong"] = sum(o[1] for (i, _), o in zip(keys, out)
                                  if o[0] != want[i])
    return checks
