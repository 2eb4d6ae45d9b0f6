"""BandJAM XA container header: parse, validate, dump.

Format specification mirrored from the reference documentation
(``bjxa.5.rst:63-97``) and the reference parser's validation matrix
(``src/libbjxa.c:395-453``).  All of this is host-side metadata work on 32
bytes; it never touches the device.

The 32-byte little-endian header layout::

    offset  size  field
    0       4     magic "KWD1"
    4       4     data_len        (bytes of ADPCM payload, > 0)
    8       4     samples         (PCM frames per channel, > 0)
    12      2     samples_rate    (Hz, > 0)
    14      1     bits            (4, 6 or 8)
    15      1     channels        (1 or 2)
    16      4     loop            (ignored on decode, 0 on encode)
    20      2     prev[0] left    (initial predictor state, int16)
    22      2     prev[1] left
    24      2     prev[0] right
    26      2     prev[1] right
    28      4     pad             (ignored on decode, 0 on encode)

Derived invariants enforced exactly as the reference does
(``src/libbjxa.c:425-437``):

* ``block_size = bits * 4 + 1`` (one profile byte + 32 packed samples)
* ``data_len`` is a whole number of blocks
* ``samples <= max_samples < samples + 32`` where
  ``max_samples = 32 * data_len / (block_size * channels)``
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from bjxa_tpu_torch.errors import BjxaBufferError, BjxaFault, BjxaProtocolError

XA_HEADER_SIZE = 32
BLOCK_SAMPLES = 32
XA_MAGIC = b"KWD1"
VALID_BITS = (4, 6, 8)

_HEADER_STRUCT = struct.Struct("<4sIIHBBI4hI")
assert _HEADER_STRUCT.size == XA_HEADER_SIZE


@dataclasses.dataclass(frozen=True)
class XAFormat:
    """Validated, immutable description of one XA stream.

    Combines the reference's decoder state (``src/libbjxa.c:217-228``) and
    the ``bjxa_format_t`` it derives (``src/libbjxa.c:580-600``) into a
    single static value object: the format is computed once on the host and
    every shape the device pipelines allocate derives from it.
    """

    data_len: int
    samples: int
    samples_rate: int
    bits: int
    channels: int
    # initial predictor state, shape [2 channels][2 taps], int16 values
    initial_state: tuple[tuple[int, int], tuple[int, int]]
    loop: int = 0

    # ---- derived quantities -------------------------------------------------

    @property
    def block_size(self) -> int:
        """Bytes per single-channel block: profile byte + 32 packed samples."""
        return self.bits * 4 + 1

    @property
    def block_size_xa(self) -> int:
        """Bytes per effective (all-channel) XA block."""
        return self.block_size * self.channels

    @property
    def block_size_pcm(self) -> int:
        """Bytes per effective PCM block (32 interleaved frames)."""
        return BLOCK_SAMPLES * self.channels * 2

    @property
    def blocks(self) -> int:
        """Number of effective blocks in the stream."""
        return self.data_len // self.block_size_xa

    @property
    def blocks_per_channel(self) -> int:
        return self.data_len // self.block_size

    @property
    def data_len_pcm(self) -> int:
        """Total decoded PCM payload size in bytes."""
        return self.samples * self.channels * 2

    @property
    def max_samples(self) -> int:
        return (BLOCK_SAMPLES * self.data_len) // (
            self.block_size * self.channels
        )

    def initial_state_array(self) -> np.ndarray:
        """Initial predictor state as ``int32[channels, 2]`` (prev0, prev1)."""
        return np.asarray(
            self.initial_state[: self.channels], dtype=np.int32
        ).reshape(self.channels, 2)

    def validate(self) -> "XAFormat":
        """Apply the reference validation matrix; raise BjxaProtocolError."""
        if self.data_len <= 0:
            raise BjxaProtocolError("XA header: data_len must be positive")
        if self.samples <= 0:
            raise BjxaProtocolError("XA header: samples must be positive")
        if self.samples_rate <= 0:
            raise BjxaProtocolError("XA header: sample rate must be positive")
        if self.bits not in VALID_BITS:
            raise BjxaProtocolError(
                f"XA header: unknown compression ({self.bits} bits)"
            )
        if self.channels not in (1, 2):
            raise BjxaProtocolError(
                f"XA header: unsupported channel count {self.channels}"
            )
        if self.blocks_per_channel * self.block_size != self.data_len:
            raise BjxaProtocolError(
                "XA header: data_len is not a whole number of blocks"
            )
        if self.blocks * self.block_size_xa != self.data_len:
            # The reference's parse accepts a stereo data_len that is a
            # whole number of single-channel blocks but NOT of effective
            # blocks — and then aborts on the decode-format assert
            # (``src/libbjxa.c:597``, verified SIGABRT on the compiled
            # binary).  Rejecting at parse turns that crash into the
            # clean EPROTO every other malformed header gets.
            raise BjxaProtocolError(
                "XA header: data_len is not a whole number of"
                " effective blocks"
            )
        if self.max_samples < self.samples:
            raise BjxaProtocolError("XA header: more samples than data")
        if self.max_samples - self.samples >= BLOCK_SAMPLES:
            raise BjxaProtocolError("XA header: not enough samples for data")
        return self


def parse_xa_header(buf: bytes | bytearray | memoryview | None) -> XAFormat:
    """Parse and validate a 32-byte XA header (``src/libbjxa.c:395-453``).

    The parse is transactional by construction: a fresh XAFormat is returned
    only if every check passes, so callers holding an older format keep it
    intact on failure (the reference commits ``tmp`` by memcpy only at the
    end, ``src/libbjxa.c:451``).
    """
    if buf is None:
        raise BjxaFault("parse_xa_header: no source buffer")
    data = bytes(buf[:XA_HEADER_SIZE]) if len(buf) >= XA_HEADER_SIZE else None
    if data is None:
        raise BjxaBufferError(
            f"parse_xa_header: need {XA_HEADER_SIZE} bytes, got {len(buf)}"
        )

    (
        magic,
        data_len,
        samples,
        rate,
        bits,
        channels,
        loop,
        bef_l0,
        bef_l1,
        bef_r0,
        bef_r1,
        _pad,
    ) = _HEADER_STRUCT.unpack(data)

    if magic != XA_MAGIC:
        raise BjxaProtocolError("XA header: bad magic (expected KWD1)")

    fmt = XAFormat(
        data_len=data_len,
        samples=samples,
        samples_rate=rate,
        bits=bits,
        channels=channels,
        initial_state=((bef_l0, bef_l1), (bef_r0, bef_r1)),
        loop=loop,
    )
    return fmt.validate()


def dump_xa_header(fmt: XAFormat) -> bytes:
    """Serialize a 32-byte XA header (``src/libbjxa.c:478-503``).

    Like the reference encoder, the loop pointer, predictor seeds and padding
    are always written as zero.
    """
    if fmt is None:
        raise BjxaFault("dump_xa_header: no format")
    if fmt.data_len <= 0:
        raise BjxaProtocolError("dump_xa_header: empty stream")
    return _HEADER_STRUCT.pack(
        XA_MAGIC,
        fmt.data_len,
        fmt.samples,
        fmt.samples_rate,
        fmt.bits,
        fmt.channels,
        0,  # loop
        0,
        0,
        0,
        0,  # predictor seeds
        0,  # pad
    )
