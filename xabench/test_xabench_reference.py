"""The plain reference (``xabench/reference.py``) against the port's CPU
path on small files of every format, and the input generator's grid.

The tests may import the port; the reference may not
(``test_xabench_imports.py``)."""

from __future__ import annotations

import struct

import pytest
import torch

import bjxa_tpu_torch as bt
from xabench import gen
from xabench import reference as ref
from xabench._testing import small_cell

FORMATS = [(c, b) for c in (1, 2) for b in (4, 6, 8)]
SIG = small_cell("fixture15s.corpus_decode").config["signal"]
#: a configuration of short clips over a range of block counts
CLIPS = {"sample_rate": 44100, "channels": [1, 2], "bits": [4, 6, 8],
         "blocks": [8, 64]}


def _pcm(channels, bits, frames, seed=5):
    spec = gen.FileSpec(seed, channels, bits, frames, 44100)
    return spec, gen.signal(spec, SIG, seed, "cpu")


@pytest.mark.parametrize("channels,bits", FORMATS)
def test_decode_equals_port(channels, bits):
    spec, pcm = _pcm(channels, bits, 130 * 32 - 9)
    (xa,) = gen.make_xa([spec], [pcm])
    assert ref.xa_to_wav_many([xa], "cpu") == [bt.xa_to_wav(xa,
                                                            device="cpu")]


@pytest.mark.parametrize("channels,bits", FORMATS)
def test_decode_honours_header_seeds(channels, bits):
    spec, pcm = _pcm(channels, bits, 20 * 32)
    (xa,) = gen.make_xa([spec], [pcm])
    seeded = xa[:20] + struct.pack("<4h", 1234, -999, -32768, 32767) + xa[28:]
    assert ref.xa_to_wav_many([seeded], "cpu") == [
        bt.xa_to_wav(seeded, device="cpu")]


def test_decode_many_streams_at_once_equals_one_by_one():
    specs = gen.file_specs(CLIPS, {"files_per_format": 3}, 77)
    pcms = gen.make_pcm(specs, SIG, 77, "cpu")
    xas = gen.make_xa(specs, pcms)
    together = ref.xa_to_wav_many(xas, "cpu")
    assert together == [ref.xa_to_wav_many([x], "cpu")[0] for x in xas]
    assert together == [bt.xa_to_wav(x, device="cpu") for x in xas]


@pytest.mark.parametrize("channels,bits", FORMATS)
def test_search_equals_port(channels, bits):
    spec, pcm = _pcm(channels, bits, 90 * 32 - 5)
    (pay,) = ref.encode_streams([pcm], bits)
    want = ref.xa_image(pay, spec.frames, 44100, bits)
    got = bt.wav_to_xa(ref.wav_image(pcm, 44100), bits, device="cpu")
    assert got == want
    assert ref.judge_encoded([got], [pcm], [44100], bits) == [0]


def test_judge_finds_a_changed_block_and_header():
    spec, pcm = _pcm(2, 6, 70 * 32)
    good = bt.wav_to_xa(ref.wav_image(pcm, 44100), 6, device="cpu")
    S = ref.block_size(6)
    at = 32 + 33 * 2 * S + S + 5  # block 33, channel 1, a payload byte
    bad = good[:at] + bytes([good[at] ^ 0x40]) + good[at + 1:]
    assert ref.judge_encoded([bad], [pcm], [44100], 6)[0] >= 1
    bad_rate = good[:12] + struct.pack("<H", 22050) + good[14:]
    assert ref.judge_encoded([bad_rate], [pcm], [44100], 6) == [70 * 2]


@pytest.mark.parametrize("bits", (4, 6, 8))
def test_pack_unpack_round_trip(bits):
    g = torch.Generator().manual_seed(bits)
    raw = torch.randint(0, 256, (7, 4 * bits), generator=g,
                        dtype=torch.int32).to(torch.uint8)
    assert torch.equal(ref.pack(ref.unpack(raw, bits), bits), raw)


@pytest.mark.parametrize("channels", (1, 2))
def test_headers_equal_port(channels):
    assert ref.wav_header(4000, 44100, channels) == bt.dump_riff_header(
        4000, 44100, channels)
    fmt = bt.XAFormat(data_len=2 * channels * 25, samples=64,
                      samples_rate=44100, bits=6, channels=channels,
                      initial_state=((0, 0), (0, 0)))
    assert ref.xa_header(fmt.data_len, 64, 44100, 6,
                         channels) == bt.dump_xa_header(fmt)


def test_file_grid_is_the_same_for_every_seed():
    traffic = {"files_per_format": 683}
    a = gen.file_specs(CLIPS, traffic, 1)
    b = gen.file_specs(CLIPS, traffic, 2**40 + 3)
    assert a != b
    assert sorted(a, key=lambda s: s.index) == sorted(b,
                                                      key=lambda s: s.index)
    assert len(a) == 4098
    assert {s.blocks for s in a} == set(range(8, 65))
    assert {(s.channels, s.bits) for s in a} == set(FORMATS)
    assert all(s.blocks * 32 - 32 < s.frames <= s.blocks * 32 for s in a)


def test_inputs_repeat_for_a_seed():
    spec, _ = _pcm(2, 4, 50 * 32)
    a = gen.signal(spec, SIG, 2**35 + 1, "cpu")
    assert torch.equal(a, gen.signal(spec, SIG, 2**35 + 1, "cpu"))
    assert not torch.equal(a, gen.signal(spec, SIG, 2**35 + 2, "cpu"))
