"""File traffic: one client calls the one-shot API (``xa_to_wav`` or
``wav_to_xa``) on file images in memory and waits for each answer, in turn
over a pool of distinct files made before the window (a closed loop).

Each call's latency is the host clock from the call to the returned image.
Each answer is compared byte for byte with the answers already kept for its
file (a ``memcmp``, the cheapest exact record between calls); each distinct
answer is kept once, with its count, and judged once the window has closed.
"""

from __future__ import annotations

import time
import traceback

import torch

from xabench import drivers, gen
from xabench import reference as ref
from xabench.drivers import Record


class Driver:
    def __init__(self, cell, seed: int, device, workdir):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic = cell.traffic
        self.encode = self.traffic["direction"] == "encode"
        self.answers: dict[int, list] = {}  # input -> [[bytes, n], ...]
        self.raised = 0

    def make_inputs(self):
        cfg = self.cell.config
        self.specs = gen.file_specs(cfg, self.traffic, self.seed)
        pcms = gen.make_pcm(self.specs, cfg["signal"], self.seed,
                            self.device)
        if self.encode:
            self.images = [ref.wav_image(p, s.rate) for p, s in
                           zip(pcms, self.specs)]
            self.pcms = [p.cpu() for p in pcms]
        else:
            self.images = gen.make_xa(self.specs, pcms)

    def _call(self):
        import bjxa_tpu_torch.api as api

        if self.encode:
            bits = self.traffic["bits"]
            return "xabench.api.wav_to_xa", lambda im: api.wav_to_xa(
                im, bits, search=True, device=self.device)
        return "xabench.api.xa_to_wav", lambda im: api.xa_to_wav(
            im, device=self.device)

    def warm(self):
        """One call for every distinct shape of the pool, then one round
        of the pool as the window takes it."""
        _, call = self._call()
        shapes = {}
        for i, s in enumerate(self.specs):
            shapes.setdefault((s.channels, s.bits, s.blocks), i)
        for i in [*shapes.values(), *range(len(self.specs))]:
            call(self.images[i])

    def window(self, seconds: float, span) -> Record:
        name, call = self._call()
        rec = Record()
        n = len(self.specs)
        j = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            i = j % n
            j += 1
            t0 = time.perf_counter()
            try:
                with span(name):
                    out = call(self.images[i])
            except Exception:  # a failed call is a missing answer
                if not self.raised:
                    traceback.print_exc()
                self.raised += 1
                continue
            finally:
                rec.lat_ms.append((time.perf_counter() - t0) * 1e3)
            drivers.keep(self.answers, i, out)
            rec.done.append(self.specs[i])
        rec.elapsed_s = time.perf_counter() - start
        rec.attempted = j
        rec.samples = sum(s.frames * s.channels for s in rec.done)
        return rec

    def judge(self) -> dict:
        """Every answer against the reference, each distinct one once."""
        return drivers.judge(self, self.raised)
