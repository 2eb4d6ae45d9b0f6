"""The port's streaming codec (:mod:`bjxa_tpu_torch.codec`) against
:mod:`bjxa_tpu.codec` on the CPU.

Every case runs twice: with the native host library on, and with
``native.available`` patched to False in both packages (the numpy decode,
the truncation loop and the device search, here its plain version on the
CPU).  The twins must give the same bytes, end state, ``FormatInfo``
progress, and exception class and errno.  The misuse and lifecycle checks
of ``tests/test_codec_api.py`` are carried over as cases of
:func:`test_api_contract`.
"""

import dataclasses
import errno
import io

import numpy as np
import pytest

import bjxa_tpu.codec as jcodec
import bjxa_tpu.native as jnative
import bjxa_tpu_torch.native as tnative
from bjxa_tpu.format.riff import RiffFormat as JRiff
from bjxa_tpu_torch import (
    BjxaBadFileError,
    BjxaBufferError,
    BjxaFault,
    BjxaInvalidState,
    BjxaIOError,
    BjxaProtocolError,
    XAFormat,
    dump_pcm,
    dump_xa_header,
)
from bjxa_tpu_torch import codec as tcodec
from bjxa_tpu_torch.api import decode_xa, encode_pcm
from bjxa_tpu_torch.format.hexdsl import hex_to_bytes
from bjxa_tpu_torch.format.riff import RiffFormat


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both codecs on the native library, or both on their numpy paths."""
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available() and jnative.available()
    return request.param


def make_blocks(rng, blocks, channels, bits, bad=None):
    """Seeded raw effective blocks with valid profiles; ``bad`` =
    (block, channel) gets an invalid profile factor."""
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(blocks, channels)) << 4
                    | rng.integers(0, 13, size=(blocks, channels)))
    if bad is not None:
        raw[bad[0], bad[1], 0] = 0x5B
    return raw


def make_xa(rng, bits, channels, samples, bad=None):
    blocks = -(-samples // 32)
    raw = make_blocks(rng, blocks, channels, bits, bad)
    state = rng.integers(-(2**15), 2**15, size=(2, 2)).tolist()
    fmt = XAFormat(data_len=raw.size, samples=samples, samples_rate=22050,
                   bits=bits, channels=channels,
                   initial_state=tuple(map(tuple, state))).validate()
    return dump_xa_header(fmt) + raw.tobytes()


def drive_decoder(mod, xa, pieces):
    """Parse ``xa``'s header and feed its payload in ``pieces`` (byte
    counts, ``max_blocks`` or None); returns what every call gave: the
    PCM bytes or the exception's class name and errno, then the state and
    progress."""
    dec = mod.Decoder()
    dec.parse_header(xa[:32])
    size = dec.xa_format.block_size_xa
    pos, trace = 32, []
    for nbytes, max_blocks in pieces:
        before = dec.format().blocks
        try:
            out = dec.decode(xa[pos:pos + nbytes], max_blocks=max_blocks)
            got = out.tobytes()
            assert out.dtype == np.int16 and out.shape[1:] == (
                dec.xa_format.channels,)
        except Exception as exc:  # noqa: BLE001 - compared across twins
            got = (type(exc).__name__, getattr(exc, "errno", None))
        pos += (before - dec.format().blocks) * size
        trace.append((got, dec._state.tolist(),
                      dataclasses.asdict(dec.format())))
    return trace


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("samples", [32 * 37, 32 * 23 - 5])
def test_decoder_matches_reference(route, bits, channels, samples):
    """Whole blocks in uneven pieces, ``max_blocks``, a partial final
    block, then the exhausted stream's EPROTO."""
    rng = np.random.default_rng(bits * 100 + channels * 10 + samples % 7)
    xa = make_xa(rng, bits, channels, samples)
    size = (4 * bits + 1) * channels
    pieces = [(size, None), (5 * size + 3, None), (10 * size, 4),
              (len(xa), None), (size, None)]
    got = drive_decoder(tcodec, xa, pieces)
    assert got == drive_decoder(jcodec, xa, pieces)
    assert got[-1][0] == ("BjxaProtocolError", errno.EPROTO)
    assert got[-2][2]["blocks"] == got[-2][2]["data_len_pcm"] == 0


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_invalid_profile_matches_reference(route, bits, channels):
    """An invalid profile mid-piece: the blocks before it decode and
    count, the channels before the bad one advance, then EPROTO; the next
    piece goes on from the bad block."""
    rng = np.random.default_rng(7 * bits + channels)
    xa = make_xa(rng, bits, channels, 32 * 20, bad=(6, channels - 1))
    size = (4 * bits + 1) * channels
    pieces = [(4 * size, None), (8 * size, None), (8 * size, None)]
    got = drive_decoder(tcodec, xa, pieces)
    assert got == drive_decoder(jcodec, xa, pieces)
    assert got[1][0] == ("BjxaProtocolError", errno.EPROTO)
    assert got[1][2]["blocks"] == 20 - 6


def drive_encoder(mod, riff, pcm, bits, search, cuts):
    enc = mod.Encoder(device="cpu") if mod is tcodec else mod.Encoder()
    enc.init(riff, bits)
    out, pos = [enc.dump_header()], 0
    for i, cut in enumerate([*cuts, len(pcm)]):
        piece = pcm[pos:cut]
        out.append(enc.encode(piece.tobytes() if i % 2 else piece,
                              search=search))
        pos = cut
        out.append((enc._state.tolist(), dataclasses.asdict(enc.format())))
    try:
        enc.encode(pcm[:32], search=search)
    except Exception as exc:  # noqa: BLE001 - compared across twins
        out.append((type(exc).__name__, getattr(exc, "errno", None)))
    return out


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("search", [True, False], ids=["search", "truncate"])
def test_encoder_matches_reference(route, bits, channels, search):
    """Arrays and raw bytes in pieces of whole blocks, a partial final
    block, the carried search state, then the exhausted stream."""
    rng = np.random.default_rng(bits + 10 * channels + search)
    frames = 32 * 11 + 13  # four pieces of three blocks: one JAX compile
    t = np.arange(frames)[:, None]
    pcm = (9000 * np.sin(t / (5.0 + np.arange(channels)))
           + rng.normal(0, 3000, (frames, channels)))
    pcm = np.clip(pcm, -32768, 32767).astype(np.int16)
    cuts = [96, 192, 288]
    got = drive_encoder(tcodec, RiffFormat(frames * 2 * channels, 22050,
                                           channels), pcm, bits, search, cuts)
    want = drive_encoder(jcodec, JRiff(frames * 2 * channels, 22050,
                                       channels), pcm, bits, search, cuts)
    assert got == want
    assert got[-1] == ("BjxaProtocolError", errno.EPROTO)


def test_device_search_needs_a_card_or_the_cpu(monkeypatch):
    """Without the native library and without a card, the search raises
    unless the CPU is asked for; it never runs there on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    pcm = np.arange(64, dtype=np.int16)[:, None] * 50
    enc = tcodec.Encoder()
    enc.init(RiffFormat(128, 8000, 1), 6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.encode(pcm, search=True)
    assert enc.format().blocks == 2  # nothing was consumed
    assert enc.encode(pcm, search=False)  # truncation stays on the host
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    enc = tcodec.Encoder()
    enc.init(RiffFormat(128, 8000, 1), 6)
    want = tcodec.Encoder(device="cpu")
    want.init(RiffFormat(128, 8000, 1), 6)
    assert enc.encode(pcm, search=True) == want.encode(pcm, search=True)


# ---------------------------------------------------------------------------
# the misuse and lifecycle contract of tests/test_codec_api.py

VALID_HEADER = hex_to_bytes(
    """
    4b574431 | KWD1
    42000000 | 66 data_len
    20000000 | 32 samples
    44ac     | 44100
    08 02    | 8 bits stereo
    00000000 | loop
    0000 0000 0000 0000 | bef
    00000000 | pad
    """
)
VALID_BLOCKS = bytes(66)
TWO_BLOCK_HEADER = hex_to_bytes(
    """
    4b574431 | KWD1
    84000000 | 132 data_len (2 stereo 8-bit blocks)
    40000000 | 64 samples
    44ac     | 44100
    08 02    | 8 bits stereo
    00000000 | loop
    0000 0000 0000 0000 | bef
    00000000 | pad
    """
)


class RO:
    def writable(self):
        return False


def ready_decoder():
    dec = tcodec.Decoder()
    dec.parse_header(VALID_HEADER)
    return dec


def case_errno_values(tmp_path):
    assert BjxaFault.errno == errno.EFAULT
    assert BjxaInvalidState.errno == errno.EINVAL
    assert BjxaBufferError.errno == errno.ENOBUFS
    assert BjxaProtocolError.errno == errno.EPROTO
    assert BjxaIOError.errno == errno.EIO
    assert BjxaBadFileError.errno == errno.EBADF


def case_double_close(tmp_path):
    dec = tcodec.Decoder()
    dec.close()
    with pytest.raises(BjxaInvalidState):
        dec.close()
    with pytest.raises(BjxaInvalidState):
        dec.parse_header(VALID_HEADER)


def case_parse_header_misuse(tmp_path):
    dec = tcodec.Decoder()
    with pytest.raises(BjxaFault):
        dec.parse_header(None)
    with pytest.raises(BjxaBufferError):
        dec.parse_header(b"")
    with pytest.raises(BjxaFault):
        dec.read_header(None)


def case_read_header_short_stream(tmp_path):
    with pytest.raises(BjxaIOError):
        tcodec.Decoder().read_header(io.BytesIO(b"KWD1"))


def case_parse_header_transactional(tmp_path):
    dec = ready_decoder()
    fmt_before = dec.xa_format
    with pytest.raises(BjxaProtocolError):
        dec.parse_header(b"KWD2" + VALID_HEADER[4:])
    assert dec.xa_format == fmt_before  # old state intact
    assert dec.format().blocks == 1


def case_format_before_header(tmp_path):
    with pytest.raises(BjxaInvalidState):
        tcodec.Decoder().format()


def case_decode_misuse(tmp_path):
    with pytest.raises(BjxaInvalidState):
        tcodec.Decoder().decode(VALID_BLOCKS)
    dec = ready_decoder()
    with pytest.raises(BjxaFault):
        dec.decode(None)
    with pytest.raises(BjxaBufferError):
        dec.decode(b"")
    with pytest.raises(BjxaBufferError):
        dec.decode(bytes(65))  # one byte short of a stereo block


def case_decode_past_end(tmp_path):
    dec = ready_decoder()
    assert dec.decode(VALID_BLOCKS).shape == (32, 2)
    with pytest.raises(BjxaProtocolError):
        dec.decode(VALID_BLOCKS)


def case_decode_progress_counts_down(tmp_path):
    dec = ready_decoder()
    assert dec.format().blocks == 1
    assert dec.format().data_len_pcm == 32 * 2 * 2
    dec.decode(VALID_BLOCKS)
    assert dec.format().blocks == 0
    assert dec.format().data_len_pcm == 0


def case_streaming_equals_single_pass(tmp_path):
    rng = np.random.default_rng(21)
    sig = rng.integers(-3000, 3000, size=(32 * 9 + 11, 2)).astype(np.int16)
    xa = encode_pcm(sig, 44100, 6, search=True, device="cpu")
    _, whole = decode_xa(xa, device="cpu")
    dec = tcodec.Decoder()
    dec.parse_header(xa[:32])
    fmt = dec.xa_format
    out, pos = [], 32
    for _ in range(fmt.blocks):
        out.append(dec.decode(xa[pos:pos + fmt.block_size_xa]))
        pos += fmt.block_size_xa
    np.testing.assert_array_equal(np.concatenate(out), whole)


def case_invalid_profile_advances_left_channel(tmp_path):
    """A bad right-channel profile fails after the left channel's state
    advanced (src/libbjxa.c:633-646 sequencing)."""
    dec = tcodec.Decoder()
    dec.parse_header(TWO_BLOCK_HEADER)
    block = bytearray(66)
    block[1:33] = bytes(range(0, 256, 8))
    block[33] = 0xFF  # right-channel profile invalid
    with pytest.raises(BjxaProtocolError):
        dec.decode(bytes(66) + bytes(block))
    assert dec.format().blocks == 1  # block 0 decoded and counted
    assert dec._state[0].tolist() != [0, 0] and dec._state[1].tolist() == [
        0, 0]


def case_riff_dump_misuse(tmp_path):
    with pytest.raises(BjxaInvalidState):
        tcodec.Decoder().dump_riff_header()
    dec = ready_decoder()
    with pytest.raises(BjxaFault):
        dec.write_riff_header(None)
    assert dec.write_riff_header(io.BytesIO()) == 44


def case_riff_dump_unwritable(tmp_path):
    dec = ready_decoder()
    with pytest.raises(BjxaBadFileError):
        dec.write_riff_header(RO())
    hdr = dec.dump_riff_header()
    assert len(hdr) == 44 and hdr[:4] == b"RIFF"


def case_pcm_dump_misuse(tmp_path):
    with pytest.raises(BjxaFault):
        dump_pcm(None)
    with pytest.raises(BjxaBufferError):
        dump_pcm(np.empty((0,), np.int16))
    with pytest.raises(BjxaFault):
        tcodec.Decoder.write_pcm(np.zeros(4, np.int16), None)
    with pytest.raises(BjxaBadFileError):
        tcodec.Decoder.write_pcm(np.zeros(4, np.int16), RO())


def case_encoder_misuse(tmp_path):
    enc = tcodec.Encoder()
    with pytest.raises(BjxaInvalidState):
        enc.format()
    with pytest.raises(BjxaInvalidState):
        enc.dump_header()
    with pytest.raises(BjxaFault):
        enc.init(None, 6)
    with pytest.raises(BjxaInvalidState):
        enc.init(RiffFormat(64, 44100, 1), 5)
    with pytest.raises(BjxaProtocolError):
        enc.init(RiffFormat(0, 44100, 1), 6)


def case_encoder_progress_and_exhaustion(tmp_path):
    enc = tcodec.Encoder()
    enc.init(RiffFormat(2 * 40, 8000, 1), 4)
    fmt = enc.xa_format
    assert fmt.blocks == 2  # 40 samples -> 2 blocks (last partial)
    hdr = enc.dump_header()
    assert len(hdr) == 32 and hdr[:4] == b"KWD1"
    sig = np.arange(40, dtype=np.int16) * 100
    assert len(enc.encode(sig)) == 2 * fmt.block_size
    assert enc.format().blocks == 0
    with pytest.raises(BjxaProtocolError):
        enc.encode(sig)


def case_encoder_streaming_matches_whole(tmp_path):
    rng = np.random.default_rng(5)
    sig = rng.integers(-2000, 2000, size=(32 * 6 + 3, 1)).astype(np.int16)
    for search in (False, True):
        enc = tcodec.Encoder()
        enc.init(RiffFormat(sig.size * 2, 44100, 1), 6)
        assert enc.dump_header() + enc.encode(sig, search=search) == (
            encode_pcm(sig, 44100, 6, search=search, device="cpu"))


def case_decoder_file_misuse(tmp_path):
    dec = ready_decoder()
    with pytest.raises(BjxaFault):
        dec.read_header(None)
    with pytest.raises(BjxaFault):
        dec.decode(None)
    with pytest.raises(BjxaFault):
        dec.write_pcm(np.zeros((4, 2), np.int16), None)
    ro = tmp_path / "ro.bin"
    ro.write_bytes(b"x")
    with open(ro, "rb") as f:
        with pytest.raises(BjxaBadFileError):
            dec.write_pcm(np.zeros((4, 2), np.int16), f)
    # objects without writable() count as unusable, not errors
    with pytest.raises(BjxaBadFileError):
        dec.write_pcm(np.zeros((4, 2), np.int16), object())


def case_encoder_file_misuse(tmp_path):
    enc = tcodec.Encoder()
    with pytest.raises(BjxaFault):
        enc.read_riff_header(None, 6)
    with pytest.raises(BjxaIOError):
        enc.read_riff_header(io.BytesIO(b"RIFF"), 6)
    enc.init(RiffFormat(64, 44100, 1), 6)
    with pytest.raises(BjxaFault):
        enc.write_header(None)
    ro = tmp_path / "ro.bin"
    ro.write_bytes(b"x")
    with open(ro, "rb") as f:
        with pytest.raises(BjxaBadFileError):
            enc.write_header(f)
    with pytest.raises(BjxaFault):
        enc.encode(None)
    enc.close()
    with pytest.raises(BjxaInvalidState):
        enc.encode(np.zeros((32, 1), np.int16))
    with pytest.raises(BjxaInvalidState):
        enc.close()


def case_encoder_accepts_raw_pcm_bytes(tmp_path):
    enc = tcodec.Encoder()
    enc.init(RiffFormat(64, 44100, 1), 6)
    sig = (np.arange(32, dtype=np.int16) * 64).tobytes()
    assert len(enc.encode(sig)) == enc.xa_format.block_size
    enc2 = tcodec.Encoder()
    enc2.init(RiffFormat(256, 44100, 1), 6)
    with pytest.raises(BjxaBufferError):  # less than one whole block
        enc2.encode(np.zeros((4, 1), np.int16))


def case_decode_max_blocks(tmp_path):
    sig = np.arange(96, dtype=np.int16)[:, None] * 17
    xa = encode_pcm(sig, 44100, 8, search=False, device="cpu")
    dec = tcodec.Decoder()
    dec.parse_header(xa[:32])
    fmt = dec.xa_format
    assert dec.decode(xa[32:], max_blocks=1).shape[0] == 32
    assert dec.format().blocks == fmt.blocks - 1


def case_saturating_stream_matches_whole_file(tmp_path):
    rng = np.random.default_rng(31)
    sig = rng.integers(-32768, 32768, size=(32 * 7 + 5, 2)).astype(np.int16)
    xa = encode_pcm(sig, 44100, 6, search=True, device="cpu")
    _, whole = decode_xa(xa, device="cpu")
    dec = tcodec.Decoder()
    dec.parse_header(xa[:32])
    np.testing.assert_array_equal(dec.decode(xa[32:]), whole)
    assert dec.format().blocks == 0


def case_invalid_profile_counts_blocks_before(tmp_path):
    dec = tcodec.Decoder()
    dec.parse_header(TWO_BLOCK_HEADER)
    bad = bytearray(66)
    bad[33] = 0xFF  # right channel invalid, left valid
    with pytest.raises(BjxaProtocolError):
        dec.decode(bytes(66) + bytes(bad))
    assert dec.format().blocks == 1


def case_encoder_matches_one_shot_both_modes(tmp_path):
    rng = np.random.default_rng(32)
    sig = rng.integers(-9000, 9000, size=(32 * 4 + 9, 2)).astype(np.int16)
    for search in (False, True):
        enc = tcodec.Encoder()
        enc.init(RiffFormat(sig.size * 2, 44100, 2), 6)
        streamed = enc.dump_header() + enc.encode(sig, search=search)
        assert streamed == encode_pcm(sig, 44100, 6, search=search,
                                      device="cpu"), f"search={search}"


def case_read_header_from_stream(tmp_path):
    dec = tcodec.Decoder()
    src = io.BytesIO(VALID_HEADER + VALID_BLOCKS)
    assert dec.read_header(src) == 32
    assert dec.decode(src.read()).shape == (32, 2)
    enc = tcodec.Encoder()
    riff = dec.dump_riff_header()
    assert enc.read_riff_header(io.BytesIO(riff), 8) == 44
    assert enc.format().channels == 2 and enc.format().sample_bits == 8


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_api_contract(route, case, tmp_path):
    CASES[case](tmp_path)
