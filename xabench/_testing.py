"""Small cells for the benchmark's CPU tests: the committed cells with
their files cut to a few blocks."""

from __future__ import annotations

import time

from xabench import run, spec

CELLS = ("fixture15s.corpus_decode", "fixture15s.file_decode",
         "fixture15s.corpus_encode", "fixture15s.file_encode")


def small_cell(name: str, blocks: int = 40) -> spec.Cell:
    """The cell ``name`` (``<config>.<traffic>``, in ``BENCHMARK.json`` or
    not) with ``blocks``-block files and at most two files a format."""
    config, traffic = name.split(".", 1)
    cell = spec.make_cell(spec.bench(), name, config, traffic)
    cell.config["frames"] = blocks * 32 - 3
    cell.traffic["files_per_format"] = min(
        cell.traffic["files_per_format"], 2)
    return cell


def run_small(name: str, seed: int = 2**40 + 11, trace: bool = False,
              seconds: float = 0.3) -> dict:
    """One run of the small cell on the CPU."""
    return run.run_cell(small_cell(name), seed, seconds, trace, "cpu",
                        time.perf_counter())
