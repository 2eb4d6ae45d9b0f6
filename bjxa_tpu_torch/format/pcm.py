"""PCM sample (de)serialization — host-endian independent.

The reference serializes int16 samples byte-by-byte to guarantee
little-endian output on any host (``src/libbjxa.c:947-996``).  Here numpy's
explicit ``<i2`` dtype gives the same guarantee in bulk.
"""

from __future__ import annotations

import numpy as np

from bjxa_tpu_torch.errors import BjxaBufferError, BjxaFault
from bjxa_tpu_torch.utils.hostcopy import copy_into


def dump_pcm(samples: np.ndarray | None) -> bytes:
    """Serialize int16 samples to little-endian bytes.

    ``samples`` may be any shape; C-order flattening defines the byte order,
    which for ``[frames, channels]`` arrays yields interleaved output.
    """
    if samples is None:
        raise BjxaFault("dump_pcm: no samples")
    arr = np.asarray(samples)
    if arr.size == 0:
        raise BjxaBufferError("dump_pcm: empty sample buffer")
    return arr.astype("<i2", copy=False).tobytes()


def pcm_frames(buf: bytes | bytearray | memoryview, channels: int = 1) -> int:
    """The frame count of little-endian int16 bytes, checked as
    :func:`load_pcm` checks them."""
    if buf is None:
        raise BjxaFault("load_pcm: no source buffer")
    if len(buf) == 0 or len(buf) % (2 * channels) != 0:
        raise BjxaBufferError("load_pcm: byte length not a whole frame count")
    return len(buf) // (2 * channels)


def load_pcm(buf: bytes | bytearray | memoryview, channels: int = 1,
             out: np.ndarray | None = None) -> np.ndarray:
    """Deserialize little-endian int16 bytes to ``int16[frames, channels]``,
    in one copy: into a new array, or into ``out`` (``int16[frames,
    channels]``, e.g. a view of a reused staging buffer; a large copy is
    split over a few threads), which is returned."""
    pcm_frames(buf, channels)
    flat = np.frombuffer(buf, dtype="<i2").reshape(-1, channels)
    if out is None:
        return flat.astype(np.int16)
    copy_into(out, flat)
    return out
