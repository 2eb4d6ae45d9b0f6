"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (its ``file``
under ``configs/``) and a traffic mix (``traffic/<traffic>.json``); every
metric, end-to-end or per-layer, is read by ``metrics/<name>.py``, a module
with ``read(ctx)`` that returns the number or None.  Adding a cell or a
metric is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or every cell where it has no such key."""
    return "workloads" not in metric or cell in metric["workloads"]


def bench() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    b = bench()
    work = next((w for w in b["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return make_cell(b, name, work["config"], work["traffic"], work["chips"])


def make_cell(b: dict, name: str, config: str, traffic: str,
              chips: int = 1) -> Cell:
    """The cell ``name`` of configuration ``config`` (an entry of ``b``'s
    ``configs``) under the traffic mix ``traffic``, with the metrics of
    ``b`` that it reports."""
    conf = next(c for c in b["configs"] if c["name"] == config)
    return Cell(
        name, chips, json.loads((ROOT / conf["file"]).read_text()),
        json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
        [m for m in b["end_to_end"] if _reports(m, name)],
        [m for m in b["per_layer"] if _reports(m, name)])


def reader(metric_name: str):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"xabench_metric_{metric_name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
