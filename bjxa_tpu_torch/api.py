"""High-level one-shot conversion API.

The whole-file equivalents of the reference CLI's decode driver
(``src/bjxa_decode.c`` in its ``BJXA_SINGLE_PASS`` mode): bytes in, bytes
out, with header work on the host and sample work on the device the caller
names.
"""

from __future__ import annotations

import numpy as np
import torch

from bjxa_tpu_torch.errors import BjxaIOError
from bjxa_tpu_torch.format import (
    XA_HEADER_SIZE,
    XAFormat,
    parse_xa_header,
    dump_riff_header,
    dump_pcm,
)
from bjxa_tpu_torch.ops.decode import decode_bytes


def decode_xa(
    data: bytes, *, device: torch.device | str
) -> tuple[XAFormat, np.ndarray]:
    """Decode a whole XA file image on ``device`` to (format,
    ``int16[samples, C]``)."""
    fmt = parse_xa_header(data)
    payload = memoryview(data)[XA_HEADER_SIZE:]
    if len(payload) < fmt.data_len:
        raise BjxaIOError(
            f"XA stream truncated: header promises {fmt.data_len} bytes,"
            f" got {len(payload)}"
        )
    pcm = decode_bytes(payload[: fmt.data_len], fmt, device=device)
    return fmt, pcm


def xa_to_wav(data: bytes, *, device: torch.device | str) -> bytes:
    """Convert a whole XA file image to a canonical WAVE file image,
    decoding on ``device``."""
    fmt, pcm = decode_xa(data, device=device)
    hdr = dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    return hdr + dump_pcm(pcm)
