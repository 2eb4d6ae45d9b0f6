"""The control: the plain reference put in the program's place at the
nearest lower precision or with one guarantee broken, run through the
harness so that the same comparison judges it.  Every run must come out
not correct.

    python3 -m xabench.control --workload <name> --seeds <n> [<n> ...] \\
        --seconds <s>

The window has to be long enough to answer every input once (one pass of
a corpus, one round of a pool); a run in which no request was made is
no reading, and the command fails.

- decode: the reference decoder with the gain divided by ``>> 8`` (floor)
  where the format divides truncating toward zero, as C does;
- encode: the reference's greedy search with its squared error summed in
  bfloat16 where the search states float32 (the search itself, solved by
  its fixed point, so each block starts from the control's own state).

Benchmark runs never run it; it is run on the card at the cells' own sizes
to set the comparison's upper readings, and by the tests at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from types import SimpleNamespace
from unittest import mock

import torch

from xabench import reference as ref
from xabench import spec


def _result():
    """Stands in for the corpus engine's result: the harness reads its
    spans and failures."""
    return SimpleNamespace(counters=SimpleNamespace(stage_ms={}), failed={})


def _decode_corpus(in_dir, out_dir, *, device, **_kw):
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(pathlib.Path(in_dir).glob("*.xa"))
    wavs = ref.xa_to_wav_many([p.read_bytes() for p in paths], device,
                              div=ref.div_floor)
    for p, wav in zip(paths, wavs):
        (out_dir / (p.stem + ".wav")).write_bytes(wav)
    return _result()


def _pcm_of(wav: bytes, device):
    (_, _, _, _, _, channels, rate, _, _, _, _,
     data_len) = ref.WAV_HEADER.unpack(wav[:44])
    pcm = torch.frombuffer(bytearray(wav[44:44 + data_len]),
                           dtype=torch.int16).reshape(-1, channels)
    return pcm.to(device), rate


def _encode_images(wavs, bits, device):
    pcms, rates = zip(*(_pcm_of(w, device) for w in wavs))
    pays = ref.encode_streams(list(pcms), bits, torch.bfloat16)
    return [ref.xa_image(p, pcm.shape[0], r, bits)
            for p, pcm, r in zip(pays, pcms, rates)]


def _encode_corpus(in_dir, out_dir, *, device, bits, **_kw):
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(pathlib.Path(in_dir).glob("*.wav"))
    for p, xa in zip(paths, _encode_images([p.read_bytes() for p in paths],
                                           bits, device)):
        (out_dir / (p.stem + ".xa")).write_bytes(xa)
    return _result()


@contextlib.contextmanager
def in_place():
    """The control in the program's place, for the harness's drivers."""
    with mock.patch("bjxa_tpu_torch.parallel.corpus.decode_corpus",
                    _decode_corpus), \
            mock.patch("bjxa_tpu_torch.parallel.corpus.encode_corpus",
                       _encode_corpus), \
            mock.patch("bjxa_tpu_torch.api.xa_to_wav",
                       lambda im, *, device: ref.xa_to_wav_many(
                           [im], device, div=ref.div_floor)[0]), \
            mock.patch("bjxa_tpu_torch.api.wav_to_xa",
                       lambda im, bits, *, search, device: _encode_images(
                           [im], bits, device)[0]):
        yield


def main(argv=None) -> int:
    from xabench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    bad = empty = 0
    # the control has nothing to warm up: its runs are judged, not timed
    with in_place(), \
            mock.patch("xabench.drivers.corpus.Driver.warm", lambda _: None), \
            mock.patch("xabench.drivers.file.Driver.warm", lambda _: None):
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = run.run_cell(cell, seed, args.seconds, False, device, t0)
            bad += res["correct"]
            empty += not res["attempted"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control_correct": res["correct"],
                              "attempted": res["attempted"],
                              "checks": res["checks"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 1 if bad or empty else 0


if __name__ == "__main__":
    sys.exit(main())
