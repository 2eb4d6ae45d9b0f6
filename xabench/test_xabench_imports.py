"""What a run loads: no JAX and no JAX package anywhere, and nothing of
the program in the reference and the yardstick; a run outside a full
checkout, or without a card, prints no result."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "bjxa_tpu"}


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _top_level(out: str) -> set:
    return set(json.loads(out.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["fixture15s.corpus_decode",
                                  "fixture15s.file_encode"])
def test_a_run_loads_no_jax(cell):
    r = _python(
        "import json, sys\n"
        "from xabench._testing import run_small\n"
        f"assert run_small({cell!r})['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert r.returncode == 0, r.stderr
    loaded = _top_level(r.stdout)
    assert "bjxa_tpu_torch" in loaded
    assert not loaded & BANNED  # whole top-level names: not a prefix


def test_reference_and_yardstick_load_nothing_of_the_program():
    r = _python(
        "import json, sys\n"
        "import xabench.reference, xabench.work, xabench.gen\n"
        "import xabench.trace, xabench.readers\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert r.returncode == 0, r.stderr
    loaded = _top_level(r.stdout)
    assert not loaded & (BANNED | {"bjxa_tpu_torch"})


def test_no_card_no_result():
    r = subprocess.run(
        [sys.executable, "-m", "xabench.run", "--workload",
         "fixture15s.file_encode", "--seed", str(2**33 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "xabench", tmp_path / "xabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _python("from xabench._testing import run_small\n"
                "run_small('fixture15s.file_encode')", cwd=tmp_path)
    assert r.returncode != 0
    assert "bjxa_tpu_torch" in r.stderr
