"""High-level one-shot conversion API.

The whole-file equivalents of the reference CLI drivers
(``src/bjxa_decode.c``/``src/bjxa_encode.c`` in their ``BJXA_SINGLE_PASS``
mode): bytes in, bytes out, with header work on the host and sample work on
the device the caller names.  :func:`decode_xa_stream` and
:func:`encode_wav_stream` are their bounded-memory twins between binary
streams, for files of any size.
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
from bjxa_tpu_torch.format.pcm import pcm_frames
from bjxa_tpu_torch.ops.decode import (
    decode_bytes,
    iter_decode_segments,
    use_sp_mesh,
)
from bjxa_tpu_torch.ops.encode import (
    encode_stream_blocks,
    host_buffer,
    iter_encode_segments,
    read_back,
    staged_to_device,
)
from bjxa_tpu_torch.utils.hostcopy import copy_into, joined
from bjxa_tpu_torch.utils.profiler import minor_faults, span


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
    mesh=None,
    sp_axis: str = "sp",
    sp_min_blocks: int = 2048,
) -> bytes:
    """Encode interleaved PCM ``int16[samples, C]`` on ``device`` to an XA
    file image.

    ``search=True`` runs the per-block exhaustive filter-profile sweep
    (through the chunk-parallel fixed point for long streams, bit-identical
    to the sequential search); ``search=False`` reproduces the reference
    encoder byte-for-byte (profile 0, truncation only).  With a ``mesh``
    whose ``sp_axis`` has more than one device and at least
    ``sp_min_blocks`` blocks, the search's block range shards across the
    mesh's devices instead (the boundary-state ring of
    :func:`bjxa_tpu_torch.parallel.sharded.encode_file_sharded`),
    bit-identical to the sequential greedy search.

    The PCM is copied once, into the calling thread's reused staging
    buffer (:func:`bjxa_tpu_torch.ops.encode.host_buffer`), as in
    :func:`wav_to_xa`.
    """
    _check_bits(bits)
    pcm = np.asarray(pcm, dtype=np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    samples, channels = pcm.shape
    if samples <= 0:
        raise BjxaIOError("encode_pcm: empty stream")
    if channels not in (1, 2):
        raise BjxaInvalidState(f"encode_pcm: bad channel count {channels}")

    with span("bjxa.api.pad"):
        stage, staged, _grown = _staging(device, samples, channels)
        copy_into(staged[:samples], pcm)
        staged[samples:] = 0
    return _encode_staged(stage, staged, samples, samples_rate, bits,
                          search=search, device=device, mesh=mesh,
                          sp_axis=sp_axis, sp_min_blocks=sp_min_blocks)[0]


def _check_bits(bits: int) -> None:
    if bits not in (4, 6, 8):
        raise BjxaInvalidState(f"encode_pcm: invalid bit depth {bits}")


def _staging(device, samples: int, channels: int):
    """This thread's staging buffer for ``device``
    (:func:`~bjxa_tpu_torch.ops.encode.host_buffer` ``"staging"``), long
    enough for ``samples`` frames padded to whole blocks: the buffer, its
    ``int16[nblocks * 32, channels]`` view, and the bytes it grew by."""
    n = -(-samples // BLOCK_SAMPLES) * BLOCK_SAMPLES * channels
    stage = host_buffer("staging", device)
    grown = stage.take(2 * n)
    staged = stage.data[: 2 * n].numpy().view(np.int16).reshape(-1, channels)
    return stage, staged, grown


def _encode_staged(stage, staged: np.ndarray, samples: int,
                   samples_rate: int, bits: int, *, search: bool, device,
                   mesh=None, sp_axis: str = "sp",
                   sp_min_blocks: int = 2048) -> tuple[bytes, int]:
    """The XA image of the zero-padded PCM ``staged`` (``samples`` real
    frames), a view of ``stage``'s data, and the bytes the call's readback
    buffer grew by."""
    nblocks, channels = staged.shape[0] // BLOCK_SAMPLES, staged.shape[1]
    grown = 0
    if search and use_sp_mesh(mesh, sp_axis) and nblocks >= sp_min_blocks:
        from bjxa_tpu_torch.parallel.sharded import encode_file_sharded

        host, _end, _rounds = encode_file_sharded(
            staged.reshape(nblocks, BLOCK_SAMPLES, channels),
            np.zeros((channels, 2), np.int32), bits=bits, mesh=mesh,
            axis=sp_axis,
        )
    else:
        with span("bjxa.ops.h2d"):
            lanes = staged_to_device(
                stage, (nblocks, BLOCK_SAMPLES, channels), device)
        blocks = encode_stream_blocks(lanes, bits=bits, search=search)
        with span("bjxa.ops.readback"):
            host, grown = read_back(blocks)

    with span("bjxa.api.assemble"):
        fmt = XAFormat(
            data_len=host.nbytes,
            samples=samples,
            samples_rate=samples_rate,
            bits=bits,
            channels=channels,
            initial_state=((0, 0), (0, 0)),
        ).validate()
        # one copy of the payload, into the returned image
        return joined(dump_xa_header(fmt), host), grown


def decode_xa_stream(
    fin,
    fout,
    fmt: XAFormat | None = None,
    *,
    device: torch.device | str,
    segment_blocks: int | None = None,
    mesh=None,
) -> XAFormat:
    """Segmented bounded-memory XA->WAV conversion between binary streams,
    decoding on ``device`` (or, with a ``mesh`` carrying an ``sp`` axis of
    several devices, each segment sharded across them).

    Reads the XA header from ``fin`` (unless a pre-parsed ``fmt`` is given,
    in which case ``fin`` must be positioned at the payload), writes the
    RIFF header and PCM to ``fout`` segment by segment at O(segment) host
    memory: the stream twin of :func:`xa_to_wav` for u32-scale files
    (reference anchor: the streaming loop of ``src/bjxa_decode.c:102-161``).
    Shared by the CLI's segmented path and the corpus engine's oversized
    files.

    Raises :class:`~bjxa_tpu_torch.errors.BjxaProtocolError` /
    :class:`EOFError` after writing a failing stream's valid prefix.
    """
    if fmt is None:
        fmt = parse_xa_header(fin.read(XA_HEADER_SIZE))
    fout.write(
        dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    )
    kw = {} if segment_blocks is None else {"segment_blocks": segment_blocks}
    for pcm in iter_decode_segments(fin.read, fmt, device=device, mesh=mesh,
                                    **kw):
        fout.write(dump_pcm(pcm))
    return fmt


def encode_wav_stream(
    fin,
    fout,
    bits: int = 6,
    *,
    search: bool = True,
    rf=None,
    device: torch.device | str,
    segment_blocks: int | None = None,
    mesh=None,
) -> XAFormat:
    """Segmented bounded-memory WAV->XA conversion between binary streams,
    encoding on ``device`` (or, with a ``mesh`` carrying an ``sp`` axis of
    several devices, each segment's search sharded across them).

    Reads the RIFF header from ``fin`` (unless a pre-parsed ``rf`` is
    given, with ``fin`` at the PCM body), writes the XA header and packed
    blocks to ``fout`` segment by segment, carrying the exact search state:
    bytes identical to :func:`wav_to_xa` at O(segment) memory (reference
    anchor: ``src/bjxa_encode.c:108-160``).  Returns the :class:`XAFormat`
    written.  Raises :class:`EOFError` after writing a truncated stream's
    whole-block prefix.
    """
    if rf is None:
        rf = parse_riff_header(fin.read(RIFF_HEADER_SIZE))
    nblocks = -(-rf.samples // BLOCK_SAMPLES)
    fmt = XAFormat(
        data_len=nblocks * (bits * 4 + 1) * rf.channels,
        samples=rf.samples,
        samples_rate=rf.samples_rate,
        bits=bits,
        channels=rf.channels,
        initial_state=((0, 0), (0, 0)),
    ).validate()
    fout.write(dump_xa_header(fmt))
    for blocks in iter_encode_segments(
        fin.read, rf.channels, rf.samples, bits=bits, search=search,
        device=device, segment_blocks=segment_blocks, mesh=mesh,
    ):
        fout.write(blocks)
    return fmt


def wav_to_xa(
    data: bytes,
    bits: int = 6,
    *,
    search: bool = True,
    device: torch.device | str,
) -> bytes:
    """Convert a whole WAVE file image to an XA file image, encoding on
    ``device``.

    The PCM body is copied once, into the calling thread's staging buffer
    (page-locked for a CUDA device), and the packed blocks come back into
    a reused page-locked buffer: the buffers grow to the largest call so
    far and are reused, so once warm the only fresh host memory of a call
    is the image it returns (:func:`bjxa_tpu_torch.ops.encode.host_buffer`).

    Under a ``torch.profiler`` session each call is the span
    ``bjxa.api.wav_to_xa`` around the spans of its stages
    (:func:`bjxa_tpu_torch.utils.profiler.span`); the root carries
    ``minflt``, the minor page faults the call took
    (:func:`~bjxa_tpu_torch.utils.profiler.minor_faults`), and
    ``grown_bytes``, the bytes by which it grew its reused buffers (0 once
    warm)."""
    with span("bjxa.api.wav_to_xa") as root:
        faults = minor_faults() if root else 0
        with span("bjxa.format.parse_riff"):
            rf = parse_riff_header(data)
            body = memoryview(data)[RIFF_HEADER_SIZE:]
            if len(body) < rf.data_len_pcm:
                raise BjxaIOError("WAVE stream truncated")
        with span("bjxa.format.load_pcm"):
            body = body[: rf.data_len_pcm]
            samples = pcm_frames(body, rf.channels)
            _check_bits(bits)
            stage, staged, grown = _staging(device, samples, rf.channels)
            load_pcm(body, rf.channels, out=staged[:samples])
        with span("bjxa.api.pad"):
            staged[samples:] = 0
        image, grown_back = _encode_staged(stage, staged, samples,
                                           rf.samples_rate, bits,
                                           search=search, device=device)
        if root:
            root.set(minflt=minor_faults() - faults,
                     grown_bytes=grown + grown_back)
        return image
