"""High-level one-shot conversion API.

The whole-file equivalents of the reference CLI drivers
(``src/bjxa_decode.c``/``src/bjxa_encode.c`` in their ``BJXA_SINGLE_PASS``
mode): bytes in, bytes out, with header work on the host and sample work on
the device the caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from bjxa_tpu_torch.errors import BjxaInvalidState, BjxaIOError
from bjxa_tpu_torch.format import (
    BLOCK_SAMPLES,
    RIFF_HEADER_SIZE,
    XA_HEADER_SIZE,
    XAFormat,
    parse_xa_header,
    dump_xa_header,
    parse_riff_header,
    dump_riff_header,
    dump_pcm,
    load_pcm,
)
from bjxa_tpu_torch.ops.decode import decode_bytes
from bjxa_tpu_torch.ops.encode import encode_stream_blocks


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


def encode_pcm(
    pcm: np.ndarray,
    samples_rate: int,
    bits: int = 6,
    *,
    search: bool = True,
    device: torch.device | str,
) -> bytes:
    """Encode interleaved PCM ``int16[samples, C]`` on ``device`` to an XA
    file image.

    ``search=True`` runs the per-block exhaustive filter-profile sweep
    (through the chunk-parallel fixed point for long streams, bit-identical
    to the sequential search); ``search=False`` reproduces the reference
    encoder byte-for-byte (profile 0, truncation only).
    """
    if bits not in (4, 6, 8):
        raise BjxaInvalidState(f"encode_pcm: invalid bit depth {bits}")
    pcm = np.asarray(pcm, dtype=np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    samples, channels = pcm.shape
    if samples <= 0:
        raise BjxaIOError("encode_pcm: empty stream")
    if channels not in (1, 2):
        raise BjxaInvalidState(f"encode_pcm: bad channel count {channels}")

    nblocks = -(-samples // BLOCK_SAMPLES)
    padded = np.zeros((nblocks * BLOCK_SAMPLES, channels), np.int16)
    padded[:samples] = pcm
    lanes = torch.from_numpy(
        padded.reshape(nblocks, BLOCK_SAMPLES, channels)
    ).to(device)
    blocks = encode_stream_blocks(lanes, bits=bits, search=search)
    payload = blocks.cpu().numpy().tobytes()

    fmt = XAFormat(
        data_len=len(payload),
        samples=samples,
        samples_rate=samples_rate,
        bits=bits,
        channels=channels,
        initial_state=((0, 0), (0, 0)),
    ).validate()
    return dump_xa_header(fmt) + payload


def wav_to_xa(
    data: bytes,
    bits: int = 6,
    *,
    search: bool = True,
    device: torch.device | str,
) -> bytes:
    """Convert a whole WAVE file image to an XA file image, encoding on
    ``device``."""
    rf = parse_riff_header(data)
    body = memoryview(data)[RIFF_HEADER_SIZE:]
    if len(body) < rf.data_len_pcm:
        raise BjxaIOError("WAVE stream truncated")
    pcm = load_pcm(body[: rf.data_len_pcm], rf.channels)
    return encode_pcm(pcm, rf.samples_rate, bits, search=search, device=device)
