"""PCM sample (de)serialization — host-endian independent.

The reference serializes int16 samples byte-by-byte to guarantee
little-endian output on any host (``src/libbjxa.c:947-996``).  Here numpy's
explicit ``<i2`` dtype gives the same guarantee in bulk.
"""

from __future__ import annotations

import numpy as np

from bjxa_tpu_torch.errors import BjxaBufferError, BjxaFault


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


def load_pcm(buf: bytes | bytearray | memoryview, channels: int = 1) -> np.ndarray:
    """Deserialize little-endian int16 bytes to ``int16[frames, channels]``."""
    if buf is None:
        raise BjxaFault("load_pcm: no source buffer")
    if len(buf) == 0 or len(buf) % (2 * channels) != 0:
        raise BjxaBufferError("load_pcm: byte length not a whole frame count")
    flat = np.frombuffer(bytes(buf), dtype="<i2")
    return flat.reshape(-1, channels).astype(np.int16)
