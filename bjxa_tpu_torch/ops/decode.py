"""XA decode pipelines on one device: whole files and corpus batches.

Port of the single-device subset of :mod:`bjxa_tpu.ops.decode`.  Two
whole-file pipelines share the lane-vectorized filter:

* :func:`decode_arrays` — one file, lanes = channels.  The honest
  sequential-over-blocks recurrence, used for short streams; on a CUDA
  device it is one launch of the fused short-stream kernel
  (:func:`~bjxa_tpu_torch.ops.cuda_filter.fused_decode_short`).
* :func:`decode_fixpoint_lanes` — one file, lanes = chunks x channels.
  Exact intra-file parallelism: the block range is split into K chunks
  that all decode in parallel from guessed boundary predictor states,
  iterated to a fixed point.  Chunk 0 is anchored at the true header
  state and each round propagates exact end states one chunk forward, so
  the fixed point is reached in at most K rounds and is *bit-exact*;
  typical audio converges in 2-4 rounds.  Every round is one run of the
  lane-major decode (:func:`~bjxa_tpu_torch.ops.cuda_decode.
  fused_decode_lanes`, a launch of its own on a CUDA device) and one host
  sync.

Hosts call :func:`decode_bytes`, which picks a pipeline, checks profile
validity (EPROTO taxonomy) and trims the padded tail; or
:func:`iter_decode_segments`, which streams a file of any size through the
same pipelines in fixed-size block segments at O(segment) host memory.
On the CPU both take the pipelines above, as :mod:`bjxa_tpu` does.  On a
CUDA device a long stream takes neither: its payload goes to the card as
the file holds it, and ONE launch of the stream kernel
(:func:`~bjxa_tpu_torch.ops.cuda_decode.fused_decode_stream`) solves the
same chunk fixed point inside the launch and writes interleaved frames,
with no host staging, no padding and no host sync.

The batch decoders (:func:`decode_batch_lanes`, :func:`decode_batch_words`,
:func:`decode_batch_packed`) run many independent streams at once, one lane
per file channel: the corpus engine's path.  The packed-words layout
(:func:`words_from_blocks_host`) feeds the words kernel
(:mod:`bjxa_tpu_torch.ops.cuda_decode_words`).  Every function that touches
a device takes it explicitly, or works on the device of its tensors;
nothing is chosen implicitly.

Reference semantic anchors: block loop ``src/libbjxa.c:602-661``; stereo
blocks are channel-major within an effective block and PCM is interleaved
at stride ``channels``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bjxa_tpu_torch.errors import BjxaInvalidState, BjxaProtocolError
from bjxa_tpu_torch.format.xa import XAFormat
from bjxa_tpu_torch.ops.chunking import MIN_CHUNK_BLOCKS, fixpoint_states
from bjxa_tpu_torch.ops.cuda_decode import (
    fused_decode_lanes,
    fused_decode_stream,
)
from bjxa_tpu_torch.ops.cuda_filter import fused_decode_short
from bjxa_tpu_torch.ops.filter import decode_lanes
from bjxa_tpu_torch.ops.inflate import inflate_blocks
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES


# --------------------------------------------------------------------------
# single file, sequential over blocks (lanes = channels)
# --------------------------------------------------------------------------


def decode_arrays(blocks: torch.Tensor, state: torch.Tensor, *, bits: int):
    """Decode one file's blocks; lanes are its channels.

    Args:
      blocks: ``uint8[C, B, block_size]`` raw XA blocks per channel.
      state:  ``int32[C, 2]`` initial predictor state (header befL/befR).

    On the CPU: :func:`inflate_blocks`, then :func:`decode_lanes`.  On any
    other device: ONE launch of the fused short-stream kernel
    (:func:`~bjxa_tpu_torch.ops.cuda_filter.fused_decode_short`), which
    raises where there is no kernel.

    Returns ``(pcm int16[B*32, C], end_state int32[C, 2], valid bool[B, C])``
    on the tensors' device.
    """
    if blocks.device.type != "cpu":
        frames, end_state, valid, _rounds = fused_decode_short(
            blocks, state, bits=bits
        )
        return frames, end_state, valid
    profiles, samples = inflate_blocks(blocks, bits)  # [C,B], [C,B,32]
    profiles = profiles.transpose(0, 1)  # [B, C]
    samples = samples.permute(1, 2, 0)  # [B, 32, C]
    pcm, end_state, valid = decode_lanes(profiles, samples, state)
    frames = pcm.reshape(-1, pcm.shape[-1])  # [B*32, C]
    return frames, end_state, valid


# --------------------------------------------------------------------------
# single file, chunk-parallel fixed point (lanes = chunks x channels)
# --------------------------------------------------------------------------


def _unscramble_chunks(pcm_l, B: int, K: int, C: int):
    """[Bc, 32, K*C] chunk-lane output -> [B*32, C] frames (trim pad)."""
    Bc = pcm_l.shape[0]
    return (
        pcm_l.reshape(Bc, BLOCK_SAMPLES, K, C)
        .permute(2, 0, 1, 3)
        .reshape(K * Bc * BLOCK_SAMPLES, C)[: B * BLOCK_SAMPLES]
    )


def _end_from_frames(frames, B: int):
    """True end state after the last real block (padded dummy blocks drag
    lane state to zero, so recover it from the decoded samples)."""
    last = B * BLOCK_SAMPLES
    return torch.stack([frames[last - 1], frames[last - 2]], dim=-1).to(
        torch.int32
    )


def fixpoint_lanes_core(
    blocks_t: torch.Tensor,
    state: torch.Tensor,
    num_chunks: int,
    channels: int,
    b_total: int,
    *,
    bits: int,
):
    """Chunk-parallel fixed-point decode over lane-major raw blocks.

    Args:
      blocks_t: ``uint8[Bc, S, K*C]`` — raw blocks, lane-minor, lane
        ``l = k*C + c`` (chunk-major, channel-minor); trailing lanes beyond
        ``b_total`` blocks hold valid dummy pad (profile 0, zero samples).
      state:    ``int32[C, 2]`` — true entry state of chunk 0.
      b_total:  real (pre-chunk-padding) block count, ``<= K*Bc``.

    Every round runs :func:`fused_decode_lanes` states-only; the converged
    states run it once more with output.

    Returns ``(pcm int16[b_total*32, C], end int32[C, 2],
    valid bool[b_total, C], iterations int)``.
    """
    Bc, _S, KC = blocks_t.shape
    K, C = num_chunks, channels
    if KC != K * C:
        raise ValueError(f"lane count {KC} != {K} chunks x {C} channels")
    anchor = state.to(torch.int32)

    def run(states_flat, with_output):
        return fused_decode_lanes(
            blocks_t, states_flat, bits=bits, with_output=with_output
        )

    states, iters = fixpoint_states(run, anchor, K, C, max_iters=K)
    pcm_l, _ = run(states.reshape(K * C, 2), True)
    frames = _unscramble_chunks(pcm_l, b_total, K, C)
    valid_l = (blocks_t[:, 0, :] >> 4) < 5  # [Bc, K*C]
    valid = (
        valid_l.reshape(Bc, K, C)
        .permute(1, 0, 2)
        .reshape(K * Bc, C)[:b_total]
    )
    return frames, _end_from_frames(frames, b_total), valid, iters


def decode_fixpoint_lanes(
    blocks_t: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    num_chunks: int,
    channels: int,
    b_total: int,
):
    """Chunk-parallel decode of host-staged lane-major blocks.

    The single-stream fast path: the host slices the XA payload straight
    into the ``uint8[Bc, S, K*C]`` chunk-lane layout
    (:func:`chunk_lanes_from_bytes`), so the device runs no byte
    transposes.  Runs on the tensors' device.

    Returns ``(pcm int16[b_total*32, C], end int32[C, 2],
    valid bool[b_total, C], iterations int)``.
    """
    return fixpoint_lanes_core(
        blocks_t, state, num_chunks, channels, b_total, bits=bits
    )


# --------------------------------------------------------------------------
# batches of streams (lanes = files x channels): the corpus engine's path
# --------------------------------------------------------------------------


def decode_batch_lanes(blocks_t: torch.Tensor, state: torch.Tensor, *,
                       bits: int):
    """Decode lane-major raw blocks of many independent streams.

    Lanes are channel streams (files x channels, in any order the caller
    chooses): the host stages ``uint8[B, S, L]`` straight from file bytes
    and PCM comes back in the same lane order.  Runs the decode kernel
    (:func:`~bjxa_tpu_torch.ops.cuda_decode.fused_decode_lanes`) on a CUDA
    device, its plain version on the CPU.

    Args:
      blocks_t: ``uint8[B, S, L]`` raw blocks, lane-minor.
      state:    ``int32[L, 2]``.

    Returns ``(pcm int16[B, 32, L], end int32[L, 2], valid bool[B, L])``.
    """
    valid = (blocks_t[:, 0, :] >> 4) < 5
    pcm, end = fused_decode_lanes(blocks_t, state, bits=bits)
    return pcm, end, valid


def _sign_extend_32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 with the same bits."""
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def pack_words_from_lanes(blocks_t: torch.Tensor, *, bits: int):
    """Pack lane-major raw blocks into the packed-words layout on the
    tensor's device.

    ``uint8[B, S, L] -> (prof uint8[B, L], words int32[B, bits, L])``
    where word ``w`` holds payload bytes ``4w..4w+3`` little-endian (the
    payload is ``4*bits`` bytes, so there are exactly ``bits`` words per
    block).  The arithmetic is int64, since a byte shifted to bit 24 does
    not fit a signed int32.  Hosts stage words with
    :func:`words_from_blocks_host` instead.
    """
    B, S, L = blocks_t.shape
    if S != 4 * bits + 1:
        raise ValueError(
            f"pack_words_from_lanes: block size {S} != 4*{bits}+1"
        )
    pay = blocks_t[:, 1:, :].to(torch.int64).reshape(B, bits, 4, L)
    w = (pay[:, :, 0] | (pay[:, :, 1] << 8) | (pay[:, :, 2] << 16)
         | (pay[:, :, 3] << 24))
    return blocks_t[:, 0, :].contiguous(), _sign_extend_32(w)


def words_to_blocks(prof: torch.Tensor, words: torch.Tensor, *, bits: int):
    """Inverse of :func:`pack_words_from_lanes`: reassemble ``uint8[B, S,
    L]`` lane-major raw blocks from the words layout (the words kernel's
    plain version decodes through it)."""
    B, W, L = words.shape
    if W != bits:
        raise ValueError(f"words_to_blocks: {W} words per block, bits={bits}")
    wu = words.to(torch.int64) & 0xFFFFFFFF
    planes = [((wu >> (8 * q)) & 0xFF).to(torch.uint8) for q in range(4)]
    payload = torch.stack(planes, dim=2).reshape(B, 4 * W, L)
    return torch.cat([prof.to(torch.uint8)[:, None, :], payload], dim=1)


def words_from_blocks_host(
    blocks_t: np.ndarray, bits: int
) -> tuple[np.ndarray, np.ndarray]:
    """numpy twin of :func:`pack_words_from_lanes` for host staging.

    ``uint8[B, S, L] -> (prof uint8[B, L], words int32[B, bits, L])``: one
    strided copy followed by a free little-endian int32 view.
    """
    B, S, L = blocks_t.shape
    if S != 4 * bits + 1:
        raise ValueError(
            f"words_from_blocks_host: block size {S} != 4*{bits}+1"
        )
    prof = np.ascontiguousarray(blocks_t[:, 0, :])
    pay = np.ascontiguousarray(
        blocks_t[:, 1:, :].reshape(B, bits, 4, L).transpose(0, 1, 3, 2)
    )
    words = pay.view("<i4").reshape(B, bits, L)  # torch-friendly strides
    return prof, words


def decode_batch_words(prof: torch.Tensor, words: torch.Tensor,
                       state: torch.Tensor, *, bits: int):
    """Decode packed-words lane-major blocks of many independent streams.

    Same lane semantics as :func:`decode_batch_lanes`; the payload arrives
    as little-endian int32 words (:func:`pack_words_from_lanes`).  Runs
    the words kernel on a CUDA device, its plain version on the CPU.

    Args:
      prof:  ``uint8[B, L]``; words: ``int32[B, bits, L]``;
      state: ``int32[L, 2]``.

    Returns ``(pcm int16[B, 32, L], end int32[L, 2], valid bool[B, L])``:
    flat lanes, no padding, ``end`` the true end state.
    """
    from bjxa_tpu_torch.ops.cuda_decode_words import fused_decode_words

    valid = (prof >> 4) < 5
    pcm, end = fused_decode_words(prof, words, state, bits=bits)
    return pcm, end, valid


def packed_layout(blocks: int, lanes: int, bits: int):
    """Element offsets of the single-buffer batch staging layout.

    A corpus batch crosses to the device as ONE int32 buffer that
    concatenates the three inputs of :func:`decode_batch_words`:

    ``[words int32[B, bits, L] | prof bytes packed 4/int32 | state int32[L, 2]]``

    Returns ``(n_words, n_prof_words, n_state)`` element counts.
    """
    n_words = blocks * bits * lanes
    n_prof = -(-(blocks * lanes) // 4)
    return n_words, n_prof, lanes * 2


def decode_batch_packed(buf: torch.Tensor, *, bits: int, blocks: int,
                        lanes: int) -> torch.Tensor:
    """Decode one corpus batch from a single packed int32 staging buffer.

    Single-transfer twin of :func:`decode_batch_words` (layout:
    :func:`packed_layout`); the buffer is split on its device with views
    (the profile plane is a uint8 view of the bytes the host staged
    there).  Returns the PCM only, FLAT (``int16[blocks*32*lanes]``,
    reshape to ``[blocks, 32, lanes]``): profile validity is the host's
    job (it staged the profile bytes) and corpus decode never needs the
    end state.
    """
    from bjxa_tpu_torch.ops.cuda_decode_words import fused_decode_words

    B, W, L = blocks, bits, lanes
    nw, npr, nst = packed_layout(B, L, bits)
    if buf.dtype != torch.int32 or tuple(buf.shape) != (nw + npr + nst,):
        raise ValueError(
            f"decode_batch_packed: want int32[{nw + npr + nst}], got"
            f" {buf.dtype}{list(buf.shape)}"
        )
    words = buf[:nw].reshape(B, W, L)
    prof = buf[nw : nw + npr].view(torch.uint8)[: B * L].reshape(B, L)
    state = buf[nw + npr :].reshape(L, 2)
    pcm, _end = fused_decode_words(prof, words, state, bits=bits)
    return pcm.reshape(-1)


# --------------------------------------------------------------------------
# host-facing conveniences
# --------------------------------------------------------------------------


def blocks_from_bytes(data: bytes | memoryview, fmt: XAFormat) -> np.ndarray:
    """Slice an XA payload into ``uint8[C, B, block_size]`` (channel-major).

    Stereo files store the left-channel block before the right-channel block
    inside each effective block (``src/libbjxa.c:633-646``).
    """
    need = fmt.blocks * fmt.block_size_xa
    raw = np.frombuffer(data, dtype=np.uint8, count=need)
    # a copy, never a view: torch.from_numpy wants writable memory
    return raw.reshape(fmt.blocks, fmt.channels, fmt.block_size).transpose(
        1, 0, 2
    ).copy()


def pad_bucket(nblocks: int, granularity: int = 256) -> int:
    """Round a block count up to a bucket: a 4-bit mantissa times a power
    of two (<= 1/8 pad waste; pad blocks are profile-0 dummies), then to
    the linear ``granularity``.

    Identical to :func:`bjxa_tpu.ops.decode.pad_bucket`, so both packages
    pick the same chunk count K and converge in the same number of rounds.
    """
    B = nblocks
    e = max(0, B.bit_length() - 4)
    Bp = (-(-B >> e)) << e
    return -(-Bp // granularity) * granularity


def chunk_lanes_from_bytes(
    payload: bytes | memoryview,
    fmt: XAFormat,
    num_chunks: int,
    pad_blocks: int,
) -> np.ndarray:
    """Slice an XA payload straight into the chunk-lane device layout.

    Returns ``uint8[Bc, S, K*C]`` with lane ``l = k*C + c`` — the layout
    :func:`decode_fixpoint_lanes` consumes with zero device transposes.
    ``pad_blocks`` (>= ``fmt.blocks``, a multiple of ``num_chunks``) sets the
    padded block count; dummy pad blocks are all-zero (profile 0 = valid).
    """
    B, C, S, K = fmt.blocks, fmt.channels, fmt.block_size, num_chunks
    if pad_blocks < B or pad_blocks % K:
        raise ValueError(f"pad_blocks {pad_blocks} for {B} blocks, K={K}")
    Bc = pad_blocks // K
    raw = np.frombuffer(
        payload, dtype=np.uint8, count=B * fmt.block_size_xa
    ).reshape(B, C, S)
    padded = np.zeros((pad_blocks, C, S), np.uint8)
    padded[:B] = raw
    # [K, Bc, C, S] -> [Bc, S, K, C] -> [Bc, S, K*C]
    return np.ascontiguousarray(
        padded.reshape(K, Bc, C, S).transpose(1, 3, 0, 2)
    ).reshape(Bc, S, K * C)


def check_valid(valid: torch.Tensor, channels: int) -> None:
    """Raise the EPROTO-equivalent naming the first bad block, if any.

    ``valid``: ``bool[B, C]`` on any device, in stream order
    (channel-minor).
    """
    v = valid.cpu().numpy()
    if v.all():
        return
    flat = v.reshape(v.shape[0] * channels)
    idx = int(np.argmin(flat))
    raise BjxaProtocolError(
        f"invalid block profile factor in block {idx // channels}"
        f" channel {idx % channels}"
    )


#: Chunk-count heuristic: fill this many lanes when the stream is long
#: enough that each chunk keeps MIN_CHUNK_BLOCKS blocks (state transients
#: die within ~5 blocks, so the fixed point converges in a few rounds).
TARGET_LANES = 8192
MAX_CHUNKS = 4096


def pick_chunks(Bp: int, channels: int) -> int:
    """Chunk count K for ``Bp`` padded blocks (see :data:`TARGET_LANES`),
    stepped down until K divides ``Bp``.  The same choice as
    :func:`bjxa_tpu.ops.decode.decode_bytes_validity`, so both packages
    converge in the same number of rounds."""
    num_chunks = min(
        MAX_CHUNKS,
        max(1, TARGET_LANES // channels),
        max(1, Bp // MIN_CHUNK_BLOCKS),
    )
    while Bp % num_chunks:  # chunk grid must tile the padded block range
        num_chunks -= 1
    return num_chunks


def _decode_payload(payload, fmt: XAFormat, state: torch.Tensor,
                    device: torch.device):
    """Decode ``fmt.blocks`` blocks of ``payload`` on ``device`` from the
    entry ``state`` (``int32[C, 2]``, on ``device``).

    Streams of at most 64 blocks, and any whose chunk count
    (:func:`pick_chunks` over the bucketed count :func:`pad_bucket`) falls
    to 1, decode sequentially and unpadded (:func:`decode_arrays`).  Longer
    ones take the chunk-parallel fixed point: on the CPU over the bucketed
    block count (dummy profile-0 blocks pad the tail), elsewhere through
    :func:`_decode_payload_stream`.  Returns ``(frames int16[>=blocks*32,
    C], valid bool[>=blocks, C])`` on ``device``.
    """
    B = fmt.blocks
    Bp = B if B <= 64 else pad_bucket(B)
    num_chunks = pick_chunks(Bp, fmt.channels)
    if num_chunks > 1 and device.type != "cpu":
        return _decode_payload_stream(payload, fmt, state, device)
    if num_chunks > 1:
        blocks_t = chunk_lanes_from_bytes(payload, fmt, num_chunks, Bp)
        frames, _end, valid, _it = decode_fixpoint_lanes(
            torch.from_numpy(blocks_t).to(device),
            state,
            bits=fmt.bits,
            num_chunks=num_chunks,
            channels=fmt.channels,
            b_total=Bp,
        )
    else:  # B <= 64, so Bp == B: nothing to pad
        blocks = blocks_from_bytes(payload, fmt)
        frames, _end, valid = decode_arrays(
            torch.from_numpy(blocks).to(device), state, bits=fmt.bits
        )
    return frames, valid


def stream_payload_host(payload, fmt: XAFormat) -> torch.Tensor:
    """Host stage of :func:`_decode_payload_stream`: the payload's
    ``blocks*C*S`` bytes as one contiguous ``uint8`` host tensor (one copy;
    no padding, no transpose)."""
    return torch.frombuffer(
        bytearray(memoryview(payload)[: fmt.blocks * fmt.block_size_xa]),
        dtype=torch.uint8,
    )


def stream_payload_upload(host: torch.Tensor,
                          device: torch.device) -> torch.Tensor:
    """H2D stage of :func:`_decode_payload_stream`: a non-blocking copy
    to ``device``, with no host sync."""
    # pageable memory: the copy has left the host buffer when this returns
    return host.to(device, non_blocking=True)


def stream_decode_on_device(pay: torch.Tensor, fmt: XAFormat,
                            state: torch.Tensor):
    """Device stage of :func:`_decode_payload_stream`: one launch of the
    stream kernel on the payload ``pay`` (on the card), and the validity
    plane read there from the profile bytes.  Returns ``(frames
    int16[blocks*32, C], valid bool[blocks, C])``; no host sync."""
    B, C, S = fmt.blocks, fmt.channels, fmt.block_size
    frames, _end, _rounds = fused_decode_stream(pay, state, bits=fmt.bits,
                                                channels=C)
    valid = (pay.view(B, C, S)[:, :, 0] >> 4) < 5
    return frames, valid


def _decode_payload_stream(payload, fmt: XAFormat, state: torch.Tensor,
                           device: torch.device):
    """The card's long-stream branch of :func:`_decode_payload`, in three
    stages: :func:`stream_payload_host`, :func:`stream_payload_upload` and
    :func:`stream_decode_on_device`.  No padding, no transpose and no host
    sync.  Returns ``(frames int16[blocks*32, C], valid bool[blocks, C])``.
    """
    pay = stream_payload_upload(stream_payload_host(payload, fmt), device)
    return stream_decode_on_device(pay, fmt, state)


def decode_bytes_validity(
    payload: bytes | memoryview,
    fmt: XAFormat,
    *,
    device: torch.device | str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode one XA payload on ``device`` without raising on invalid
    profiles.

    The shared core of :func:`decode_bytes` and the CLI's valid-prefix
    error path (:func:`_decode_payload` from the header's state).

    Returns ``(frames int16[>=samples, C], valid bool[B, C])`` on
    ``device`` — frames past the first invalid block are garbage (the
    reference stops there; callers slice the valid prefix).
    """
    device = torch.device(device)
    state = torch.from_numpy(fmt.initial_state_array()).to(device)
    frames, valid = _decode_payload(payload, fmt, state, device)
    return frames, valid[: fmt.blocks]


def decode_bytes(
    payload: bytes | memoryview,
    fmt: XAFormat,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """Decode one XA payload on ``device`` to interleaved PCM
    ``int16[samples, C]`` (a host numpy array).

    Chooses the chunk-parallel fixed-point pipeline for long streams and
    the plain recurrence for short ones (:func:`decode_bytes_validity`).
    Raises BjxaProtocolError on an invalid profile factor anywhere in the
    stream.
    """
    frames, valid = decode_bytes_validity(payload, fmt, device=device)
    check_valid(valid, fmt.channels)
    return frames[: fmt.samples].cpu().numpy()


#: Byte budget (payload + PCM) above which whole-file decode and encode
#: switch to the segmented bounded-memory pipelines; override with
#: ``BJXA_SEGMENT_THRESHOLD``.  The format allows u32 sizes; the reference
#: streams with O(block) memory.
SEGMENT_THRESHOLD = 256 << 20
#: Effective blocks per segment (65536 is ~3.3 MB of XA and ~16.8 MB of PCM
#: at 6-bit stereo).
SEGMENT_BLOCKS = 65536


def segment_threshold() -> int:
    """The active segmentation byte threshold (env-overridable)."""
    env = os.environ.get("BJXA_SEGMENT_THRESHOLD", "")
    if not env:
        return SEGMENT_THRESHOLD
    try:
        return int(env)
    except ValueError:
        raise BjxaInvalidState(f"Invalid BJXA_SEGMENT_THRESHOLD {env!r}")


def iter_decode_segments(
    read,
    fmt: XAFormat,
    *,
    device: torch.device | str,
    segment_blocks: int = SEGMENT_BLOCKS,
):
    """Bounded-memory decode on ``device``: stream a file through it in
    fixed-size block segments, carrying the exact predictor end state
    between segments.

    Sequential segments need no boundary fixed point: each segment's entry
    state is the true decoded state (the last two samples of the previous
    segment), so the chunk fixed point runs inside the segment as usual and
    the yielded PCM is bit-identical to the one-shot path.  Peak host memory
    is O(segment) whatever the header's u32-scale ``data_len`` says: the
    device-rate analog of the reference's O(block) streaming loop
    (``src/bjxa_decode.c:102-161``).

    Args:
      read: ``read(nbytes) -> bytes`` pulling from the stream (a short
        result means the stream is truncated).
      segment_blocks: effective blocks per segment.

    Yields interleaved ``int16[n, channels]`` numpy frames per segment.
    Raises :class:`BjxaProtocolError` after yielding a failing segment's
    valid prefix, or :class:`EOFError` after yielding a truncated stream's
    decoded prefix (callers emit the reference's stderr labels).

    Segments pipeline: a segment's PCM goes back to the host as a
    non-blocking copy into pinned memory behind a CUDA event
    (:mod:`bjxa_tpu_torch.ops.readback`) while the next segment is read,
    staged and decoded, and is waited for only just before it is yielded --
    one extra segment of host memory.  The carried state stays on the
    device.
    """
    import dataclasses

    from bjxa_tpu_torch.ops.readback import finish_readback, start_readback

    device = torch.device(device)
    C = fmt.channels
    state = torch.from_numpy(fmt.initial_state_array()).to(device)
    left_blocks = fmt.blocks
    done_blocks = 0
    pending = None  # previous segment: (host tensor, its event)

    def flush():
        nonlocal pending
        if pending is None:
            return None
        out = finish_readback(*pending)
        pending = None
        return out if out.size else None

    while left_blocks > 0:
        nblk = min(segment_blocks, left_blocks)
        payload = read(nblk * fmt.block_size_xa) or b""
        avail = len(payload) // fmt.block_size_xa
        truncated = avail < nblk
        use = avail if truncated else nblk
        if use == 0:
            out = flush()
            if out is not None:
                yield out
            raise EOFError("truncated XA stream")

        # validity from the profile plane, on the host (no device round
        # trip): block-major, channel-minor like the stream layout
        raw = np.frombuffer(
            payload, np.uint8, count=use * fmt.block_size_xa
        ).reshape(use, C, fmt.block_size)
        vb = (raw[:, :, 0] >> 4) < 5  # [use, C]
        allv = vb.all(axis=1)
        good = int(np.argmin(allv)) if not allv.all() else use
        limit = min(use * BLOCK_SAMPLES,
                    fmt.samples - done_blocks * BLOCK_SAMPLES)
        n_frames = min(good * BLOCK_SAMPLES, limit)

        sub = dataclasses.replace(
            fmt,
            data_len=use * fmt.block_size_xa,
            samples=use * BLOCK_SAMPLES,
        )
        frames, _valid = _decode_payload(
            memoryview(payload)[: sub.data_len], sub, state, device
        )
        # The carried state comes from the frames, after the last REAL
        # block: the pad blocks of a bucketed segment drag the decoder's own
        # end state away from it.  A slice on the device, no host sync.
        state = _end_from_frames(frames, use)
        readback = start_readback(frames[:n_frames])

        out = flush()  # the previous segment lands while this one decoded
        if out is not None:
            yield out
        pending = readback
        if good < use:
            out = flush()
            if out is not None:
                yield out
            idx = int(np.argmin(vb.reshape(-1)))
            raise BjxaProtocolError(
                f"invalid block profile factor in block "
                f"{done_blocks + idx // C} channel {idx % C}"
            )
        if truncated:
            out = flush()
            if out is not None:
                yield out
            raise EOFError("truncated XA stream")
        left_blocks -= use
        done_blocks += use
    out = flush()
    if out is not None:
        yield out
