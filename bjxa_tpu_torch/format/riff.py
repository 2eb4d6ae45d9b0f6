"""Canonical RIFF/WAVE header: parse, validate, dump.

The reference accepts exactly one WAVE shape — the canonical 44-byte
header with a 16-byte PCM fmt chunk immediately followed by ``data``
(``src/libbjxa.c:826-873``) — and emits the same shape on decode
(``src/libbjxa.c:898-927``).  Anything after the data length field is the
sample payload; trailing bytes beyond ``data_len`` are ignored.
"""

from __future__ import annotations

import dataclasses
import struct

from bjxa_tpu_torch.errors import BjxaBufferError, BjxaFault, BjxaProtocolError

RIFF_HEADER_SIZE = 44
WAVE_FMT_CHUNK_LEN = 16
WAVE_FORMAT_PCM = 1

_RIFF_STRUCT = struct.Struct("<4sI8sIHHIIHH4sI")
assert _RIFF_STRUCT.size == RIFF_HEADER_SIZE


@dataclasses.dataclass(frozen=True)
class RiffFormat:
    """Validated PCM stream description derived from a WAVE header."""

    data_len_pcm: int
    samples_rate: int
    channels: int
    sample_bits: int = 16

    @property
    def frame_size(self) -> int:
        return self.channels * (self.sample_bits // 8)

    @property
    def samples(self) -> int:
        """PCM frames per channel."""
        return self.data_len_pcm // self.frame_size

    def validate(self) -> "RiffFormat":
        if self.channels not in (1, 2):
            raise BjxaProtocolError(
                f"WAVE header: unsupported channel count {self.channels}"
            )
        if not 0 < self.samples_rate < 0xFFFF:
            raise BjxaProtocolError("WAVE header: sample rate out of range")
        if self.sample_bits != 16:
            raise BjxaProtocolError("WAVE header: only 16-bit PCM supported")
        if self.data_len_pcm % self.frame_size != 0:
            raise BjxaProtocolError(
                "WAVE header: data length is not a whole number of frames"
            )
        return self


def parse_riff_header(buf: bytes | bytearray | memoryview | None) -> RiffFormat:
    """Parse+validate the canonical 44-byte WAVE header.

    Validation matrix mirrors ``src/libbjxa.c:855-863`` exactly.
    """
    if buf is None:
        raise BjxaFault("parse_riff_header: no source buffer")
    if len(buf) < RIFF_HEADER_SIZE:
        raise BjxaBufferError(
            f"parse_riff_header: need {RIFF_HEADER_SIZE} bytes, got {len(buf)}"
        )

    (
        riff_magic,
        riff_len,
        wave_magic,
        fmt_len,
        fmt_tag,
        channels,
        rate,
        byte_rate,
        frame_size,
        sample_bits,
        data_magic,
        data_len,
    ) = _RIFF_STRUCT.unpack(bytes(buf[:RIFF_HEADER_SIZE]))

    if riff_magic != b"RIFF":
        raise BjxaProtocolError("WAVE header: bad RIFF magic")
    if wave_magic != b"WAVEfmt ":
        raise BjxaProtocolError("WAVE header: bad WAVEfmt magic")
    if data_magic != b"data":
        raise BjxaProtocolError("WAVE header: bad data magic")
    if riff_len < RIFF_HEADER_SIZE - 8 + data_len:
        raise BjxaProtocolError("WAVE header: RIFF length too small for data")
    if fmt_len != WAVE_FMT_CHUNK_LEN:
        raise BjxaProtocolError("WAVE header: non-canonical fmt chunk length")
    if fmt_tag != WAVE_FORMAT_PCM:
        raise BjxaProtocolError("WAVE header: not linear PCM")
    if channels not in (1, 2):
        raise BjxaProtocolError("WAVE header: unsupported channel count")
    if not 0 < rate < 0xFFFF:
        raise BjxaProtocolError("WAVE header: sample rate out of range")
    if frame_size != channels * 2:
        raise BjxaProtocolError("WAVE header: bad block alignment")
    if byte_rate != rate * frame_size:
        raise BjxaProtocolError("WAVE header: inconsistent byte rate")
    if data_len % frame_size != 0:
        raise BjxaProtocolError("WAVE header: partial trailing frame")
    if sample_bits != 16:
        raise BjxaProtocolError("WAVE header: only 16-bit PCM supported")

    return RiffFormat(
        data_len_pcm=data_len,
        samples_rate=rate,
        channels=channels,
        sample_bits=16,
    ).validate()


def dump_riff_header(
    data_len_pcm: int, samples_rate: int, channels: int
) -> bytes:
    """Emit the canonical 44-byte WAVE header (``src/libbjxa.c:898-927``)."""
    if channels not in (1, 2):
        raise BjxaProtocolError("dump_riff_header: unsupported channel count")
    frame_size = channels * 2
    return _RIFF_STRUCT.pack(
        b"RIFF",
        RIFF_HEADER_SIZE - 8 + data_len_pcm,
        b"WAVEfmt ",
        WAVE_FMT_CHUNK_LEN,
        WAVE_FORMAT_PCM,
        channels,
        samples_rate,
        samples_rate * frame_size,
        frame_size,
        16,
        b"data",
        data_len_pcm,
    )
