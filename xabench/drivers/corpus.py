"""Corpus traffic: a directory of files converted by the corpus engine
(``decode_corpus`` or ``encode_corpus``), pass after pass.

Each pass writes into a fresh output directory (the engine's manifest would
skip files already converted).  The window is a whole number of passes,
begun until the passes have taken the window's seconds; its time is the sum
of the passes' own.  Between passes, off that clock, each output file is
compared byte for byte with the answers already kept for its input, each
distinct answer is kept once with its count, and the pass's directory is
deleted, so a run holds at most one pass on disk.  The distinct answers
are judged once the window has closed.
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import time

import torch

from xabench import drivers, gen
from xabench import reference as ref
from xabench.drivers import Record


#: Passes of the warm-up.
WARM_PASSES = 3


class Driver:
    def __init__(self, cell, seed: int, device, workdir: pathlib.Path):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic = cell.traffic
        self.encode = self.traffic["direction"] == "encode"
        self.workdir = pathlib.Path(workdir)
        self.in_dir = self.workdir / "in"
        self.passes = 0
        self.answers: dict[int, list] = {}  # input -> [[bytes, n], ...]
        self.missing = 0
        self.failed: list[str] = []

    # ---------------------------------------------------------- set-up

    def make_inputs(self):
        cfg = self.cell.config
        self.specs = gen.file_specs(cfg, self.traffic, self.seed)
        pcms = gen.make_pcm(self.specs, cfg["signal"], self.seed,
                            self.device)
        self.in_dir.mkdir(parents=True)
        if self.encode:
            images = [ref.wav_image(p, s.rate) for p, s in
                      zip(pcms, self.specs)]
            self.pcms = [p.cpu() for p in pcms]
            suffix = ".wav"
        else:
            images = gen.make_xa(self.specs, pcms)
            self.images = images
            suffix = ".xa"
        for s, image in zip(self.specs, images):
            (self.in_dir / (s.name + suffix)).write_bytes(image)
        self.samples = sum(s.frames * s.channels for s in self.specs)

    def _run(self):
        if self.encode:
            from bjxa_tpu_torch.parallel.corpus import encode_corpus as fn
            kw = dict(bits=self.traffic["bits"], search=True)
        else:
            from bjxa_tpu_torch.parallel.corpus import decode_corpus as fn
            kw = {}
        return fn, dict(device=self.device,
                        batch_files=self.traffic["batch_files"],
                        depth=self.traffic["depth"], **kw)

    def warm(self):
        """:data:`WARM_PASSES` passes: the first builds and loads what the
        cell's shapes need, the others let the program's pinned-memory cache
        and the host's page cache reach the state the window runs in."""
        fn, kw = self._run()
        for k in range(WARM_PASSES):
            out = self.workdir / f"warm{k}"
            fn(self.in_dir, out, **kw)
            shutil.rmtree(out)

    # ---------------------------------------------------------- window

    def window(self, seconds: float, span) -> Record:
        fn, kw = self._run()
        name = f"xabench.corpus.{fn.__name__}"
        rec = Record()
        while rec.elapsed_s < seconds:
            out = self.workdir / f"pass{self.passes}"
            self.passes += 1
            t0 = time.perf_counter()
            with span(name):
                res = fn(self.in_dir, out, **kw)
            rec.pass_s.append(time.perf_counter() - t0)
            rec.elapsed_s += rec.pass_s[-1]
            for stage, ms in res.counters.stage_ms.items():
                rec.stage_ms[stage] = rec.stage_ms.get(stage, 0.0) + ms
            self.failed += [f"{p}: {m}" for p, m in res.failed.items()]
            self._keep(out)
            rec.passes += 1
        rec.attempted = rec.passes * len(self.specs)
        rec.done = self.specs * rec.passes
        rec.samples = rec.passes * self.samples
        return rec

    def _keep(self, out: pathlib.Path) -> None:
        """Record every output file of a pass, then delete the pass."""
        suffix = ".xa" if self.encode else ".wav"
        for i, s in enumerate(self.specs):
            path = out / (s.name + suffix)
            if path.exists():
                drivers.keep(self.answers, i, path.read_bytes())
            else:
                self.missing += 1
        shutil.rmtree(out)

    # ----------------------------------------------------------- judge

    def judge(self) -> dict:
        """Every distinct output of every pass against the reference."""
        for msg in self.failed[:5]:
            print(f"xabench: the program failed {msg}", file=sys.stderr)
        return drivers.judge(self, self.missing)
