"""Host layer of the PyTorch port against the JAX package: XA/RIFF header
parse and dump, the malformed-stream rejection matrix (same exception
class, errno and message), PCM bytes and the gain tables.
"""

import struct

import numpy as np
import pytest

import bjxa_tpu
import bjxa_tpu.ops.tables as jax_tables
import bjxa_tpu_torch
import bjxa_tpu_torch.ops.tables as torch_tables
from bjxa_tpu.format.hexdsl import hex_to_bytes
from bjxa_tpu_torch.format.hexdsl import hex_to_bytes as torch_hex_to_bytes
from test_format_errors import (
    INVALID_MONO_PROFILE,
    INVALID_RIGHT_PROFILE,
    riff_header,
    xa_header,
)


def _outcome(fn, *args):
    """(class name, errno, message) of what ``fn`` raised, or its value."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return (type(e).__name__, getattr(e, "errno", None), str(e))


XA_HEADERS = [
    b"",
    xa_header()[:31],
    xa_header(magic="4b574432"),
    xa_header(data_len="00000000"),
    xa_header(samples="00000000"),
    xa_header(samples="a1bb0d00"),
    xa_header(samples="2a000000"),
    xa_header(rate="0000"),
    xa_header(data_len="23000000", samples="10000000"),
    xa_header(bits="0c"),
    xa_header(channels="05"),
    struct.pack("<4sIIHBBI4hI", b"KWD1", 125, 49, 44100, 6, 2, 0, 0, 0, 0,
                0, 0),
    struct.pack("<4sIIHBBI4hI", b"KWD1", 125, 155, 44100, 6, 1, 7, -3, 9,
                -32768, 32767, 0),
    xa_header(),
]


@pytest.mark.parametrize("header", XA_HEADERS, ids=range(len(XA_HEADERS)))
def test_xa_header_parse_matches(header):
    got = _outcome(bjxa_tpu_torch.parse_xa_header, header)
    want = _outcome(bjxa_tpu.parse_xa_header, header)
    if want[0] == "ok":
        assert got[0] == "ok"
        assert got[1].__dict__ == want[1].__dict__
        np.testing.assert_array_equal(
            got[1].initial_state_array(), want[1].initial_state_array()
        )
    else:
        assert got == want


RIFF_CASES = [
    {}, dict(riff="52494600"), dict(wavefmt="57415645666d7400"),
    dict(data="64617400"), dict(riff_len="10000000"),
    dict(fmt_len="12000000"), dict(fmt_tag="0300"), dict(channels="0500"),
    dict(rate="00000000"), dict(rate="ffff0000"), dict(frame="0400"),
    dict(byte_rate="00000000"), dict(data_len="01b01400"),
    dict(sample_bits="0800"),
]


@pytest.mark.parametrize("kwargs", RIFF_CASES, ids=range(len(RIFF_CASES)))
def test_riff_header_parse_matches(kwargs):
    hdr = riff_header(**kwargs)
    for buf in (hdr, hdr[:43]):
        got = _outcome(bjxa_tpu_torch.parse_riff_header, buf)
        want = _outcome(bjxa_tpu.parse_riff_header, buf)
        if want[0] == "ok":
            assert got[0] == "ok" and got[1].__dict__ == want[1].__dict__
        else:
            assert got == want


@pytest.mark.parametrize("text", [INVALID_MONO_PROFILE, INVALID_RIGHT_PROFILE])
def test_invalid_profile_decode_error_matches(text):
    data = hex_to_bytes(text)
    assert torch_hex_to_bytes(text) == data
    got = _outcome(lambda d: bjxa_tpu_torch.decode_xa(d, device="cpu"), data)
    want = _outcome(bjxa_tpu.decode_xa, data)
    assert got[0] == want[0] == "BjxaProtocolError"
    assert got == want


def test_truncated_payload_error_matches():
    hdr = xa_header(data_len="21000000", samples="20000000")
    data = hdr + b"\x00" * 10
    got = _outcome(lambda d: bjxa_tpu_torch.decode_xa(d, device="cpu"), data)
    assert got == _outcome(bjxa_tpu.decode_xa, data)
    assert got[0] == "BjxaIOError"


@pytest.mark.parametrize("seed", range(4))
def test_header_dump_roundtrip_matches(seed):
    rng = np.random.default_rng(seed)
    bits = int(rng.choice([4, 6, 8]))
    channels = int(rng.integers(1, 3))
    blocks = int(rng.integers(1, 5000))
    kw = dict(
        data_len=blocks * (4 * bits + 1) * channels,
        samples=blocks * 32 - int(rng.integers(0, 32)),
        samples_rate=int(rng.integers(1, 65535)),
        bits=bits,
        channels=channels,
        initial_state=((0, 0), (0, 0)),
    )
    xa_t = bjxa_tpu_torch.dump_xa_header(bjxa_tpu_torch.XAFormat(**kw))
    assert xa_t == bjxa_tpu.dump_xa_header(bjxa_tpu.XAFormat(**kw))
    assert bjxa_tpu_torch.parse_xa_header(xa_t).__dict__ == dict(kw, loop=0)
    fmt = bjxa_tpu_torch.parse_xa_header(xa_t)
    riff_t = bjxa_tpu_torch.dump_riff_header(
        fmt.data_len_pcm, fmt.samples_rate, fmt.channels
    )
    assert riff_t == bjxa_tpu.dump_riff_header(
        fmt.data_len_pcm, fmt.samples_rate, fmt.channels
    )
    assert (
        bjxa_tpu_torch.parse_riff_header(riff_t).__dict__
        == bjxa_tpu.parse_riff_header(riff_t).__dict__
    )


def test_pcm_bytes_match():
    rng = np.random.default_rng(3)
    pcm = rng.integers(-(2**15), 2**15, size=(97, 2)).astype(np.int16)
    raw = bjxa_tpu_torch.dump_pcm(pcm)
    assert raw == bjxa_tpu.dump_pcm(pcm)
    np.testing.assert_array_equal(
        bjxa_tpu_torch.load_pcm(raw, 2), bjxa_tpu.load_pcm(raw, 2)
    )


def test_gain_tables_equal():
    for name in ("GAIN_K0", "GAIN_K1"):
        a, b = getattr(torch_tables, name), getattr(jax_tables, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("BLOCK_SAMPLES", "NUM_FACTORS", "NUM_RANGES", "INT16_MIN",
                 "INT16_MAX"):
        assert getattr(torch_tables, name) == getattr(jax_tables, name)


def test_error_taxonomy_matches():
    import bjxa_tpu.errors as je
    import bjxa_tpu_torch.errors as te

    names = [n for n in dir(je) if n.startswith("Bjxa")]
    assert names == [n for n in dir(te) if n.startswith("Bjxa")]
    for n in names:
        assert getattr(te, n)("m").errno == getattr(je, n)("m").errno
        assert [c.__name__ for c in getattr(te, n).__mro__] == [
            c.__name__ for c in getattr(je, n).__mro__
        ]
