"""Fused raw-bytes XA decode: the CUDA kernels and their plain twins.

Port of :mod:`bjxa_tpu.ops.pallas_decode` (the raw-bytes half).  Two
kernels replace ``pallas_decode._decode_kernel`` (with output) and
``pallas_decode._states_kernel`` (end state only): profile decode, gain
select, 4/6/8-bit unpack, range shift and the prediction filter in one
pass over the raw block bytes.  Both are bound by memory bytes
(``bits/8 + 1/32`` B read and 2 B written per sample).

* ``csrc/decode_stream.cu`` (:func:`fused_decode_stream`) decodes one
  whole stream from the file's own payload bytes into interleaved frames:
  each channel's blocks are cut into chunks (:func:`pick_stream_chunks`)
  whose entry states are solved by an exact fixed point inside one
  cooperative launch.  It carries the whole-file decode on the card.
* ``csrc/decode_lanes.cu`` (:func:`fused_decode_lanes`) decodes
  lane-major ``[B, S, L]`` blocks, one thread per lane: the layout of
  ``bjxa_tpu``'s ``decode_fixpoint_lanes`` and the batch decoders, whose
  every fixed-point round is a launch of its own.

:func:`fused_decode_lanes` routes by the tensors' device alone: a CPU
tensor takes :func:`fused_decode_lanes_plain`, a CUDA tensor launches the
kernel, anything else raises.  :func:`fused_decode_stream` runs on CUDA
tensors only; its plain twins are :func:`fused_decode_stream_plain` (the
sequential decode) and :func:`fused_decode_stream_chunked_plain` (the
kernel's own schedule and round count).  Nothing is padded.
"""

from __future__ import annotations

import functools

import torch

from bjxa_tpu_torch.ops.chunking import (
    CTA_THREADS,
    MIN_CHUNK_BLOCKS,
    TARGET_LANES_PER_SM,
    fixpoint_states,
    word_chunks,
)
from bjxa_tpu_torch.ops.cuda_filter import adpcm_filter_plain
from bjxa_tpu_torch.ops.filter import profile_gains
from bjxa_tpu_torch.ops.inflate import inflate_lanes

#: Launches of the lanes kernel in this process (plain runs never count).
LAUNCHES = 0
#: Launches of the stream kernel in this process (plain runs never count).
STREAM_LAUNCHES = 0


def fused_decode_lanes_plain(
    blocks_t: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the decode kernel: lane-major unpack
    (:func:`inflate_lanes`), gains, then the filter recurrence
    (:func:`adpcm_filter_plain`).  Same arguments and returns as
    :func:`fused_decode_lanes`, on any device; it never launches a
    kernel."""
    profiles, samples = inflate_lanes(blocks_t, bits)
    k0, k1, shift, _valid = profile_gains(profiles)
    return adpcm_filter_plain(
        samples, k0, k1, shift, state, with_output=with_output
    )


def _launch(blocks_t, state, *, bits, with_output):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    B, S, L = blocks_t.shape
    if S != 4 * bits + 1:
        raise ValueError(f"fused_decode_lanes: block size {S} != 4*{bits}+1")
    if blocks_t.dtype != torch.uint8 or state.dtype != torch.int32:
        raise TypeError(
            "fused_decode_lanes: want uint8 blocks and int32 state, got"
            f" {blocks_t.dtype} and {state.dtype}"
        )
    if tuple(state.shape) != (L, 2):
        raise ValueError(f"fused_decode_lanes: state {tuple(state.shape)}"
                         f" != ({L}, 2)")
    if state.device != blocks_t.device:
        raise ValueError("fused_decode_lanes: blocks and state on"
                         f" {blocks_t.device} and {state.device}")
    if not (blocks_t.is_contiguous() and state.is_contiguous()):
        raise ValueError("fused_decode_lanes: inputs must be contiguous")
    dev = blocks_t.device
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    pcm = (
        torch.empty((B, 32, L), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    if L == 0:
        return pcm, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().bjxa_decode_lanes(
        blocks_t.data_ptr(), state.data_ptr(),
        pcm.data_ptr() if pcm is not None else None, end.data_ptr(),
        B, L, bits, int(with_output), dev.index, stream,
    )
    check_launch(err, "bjxa_decode_lanes")
    LAUNCHES += 1
    return pcm, end


def fused_decode_lanes(
    blocks_t: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Decode lane-transposed raw blocks.

    Args:
      blocks_t: ``uint8[B, S, L]`` — raw XA channel blocks, lane-minor
        (``S = 4*bits + 1``, profile byte first).
      state:    ``int32[L, 2]`` — (prev0, prev1) per lane.
      with_output: False computes only the end state (the fixed-point
        rounds).

    Returns ``(pcm int16[B, 32, L] | None, end_state int32[L, 2])``,
    bit-exact with every other decode path; profile validity is not
    checked here (callers derive it from the profile bytes).
    """
    if blocks_t.device.type == "cpu":
        return fused_decode_lanes_plain(
            blocks_t, state, bits=bits, with_output=with_output
        )
    if blocks_t.device.type != "cuda":
        raise ValueError(
            f"fused_decode_lanes: no kernel for device {blocks_t.device}"
        )
    return _launch(blocks_t, state, bits=bits, with_output=with_output)


# --------------------------------------------------------------------------
# chunked schedule shared by the stream and words kernels
# --------------------------------------------------------------------------


def chunked_lanes_plain(
    blocks_t: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    chunks: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the chunked kernels' schedule over
    lane-major blocks ``uint8[B, S, L]``: the blocks cut into
    :func:`~bjxa_tpu_torch.ops.chunking.word_chunks` ``(K, Bc)``, the
    chunks' starts iterated by
    :func:`~bjxa_tpu_torch.ops.chunking.fixpoint_states` over the
    sequential plain decode of all ``K*L`` chunk lanes at once (lane
    ``k*L + l``, the kernels' item order; the short last chunk padded with
    profile-0 blocks whose output is dropped), then one run with output.
    K = 1 runs no round.  On any device; it never launches a kernel.

    Returns ``(pcm int16[B, 32, L] | None, end int32[L, 2], rounds)``.
    """
    B, S, L = blocks_t.shape
    K, Bc = word_chunks(B, chunks)
    if K == 1:
        pcm, end = fused_decode_lanes_plain(
            blocks_t, state, bits=bits, with_output=with_output
        )
        return pcm, end, 0
    padded = torch.cat([blocks_t, blocks_t.new_zeros((K * Bc - B, S, L))])
    lanes = (padded.reshape(K, Bc, S, L).permute(1, 2, 0, 3)
             .reshape(Bc, S, K * L).contiguous())

    def run(states_flat, wo):
        return fused_decode_lanes_plain(lanes, states_flat, bits=bits,
                                        with_output=wo)

    starts, rounds = fixpoint_states(run, state.to(torch.int32), K, L,
                                      max_iters=K)
    _, end = fused_decode_lanes_plain(
        blocks_t[(K - 1) * Bc:].contiguous(), starts[K - 1].contiguous(),
        bits=bits, with_output=False,
    )
    if not with_output:
        return None, end, rounds
    pcm_l, _ = run(starts.reshape(K * L, 2), True)
    pcm = (
        pcm_l.reshape(Bc, 32, K, L)
        .permute(2, 0, 1, 3)
        .reshape(K * Bc, 32, L)[:B]
    )
    return pcm, end, rounds


# --------------------------------------------------------------------------
# the stream kernel: one whole stream in the file's own byte layout
# --------------------------------------------------------------------------


def pick_stream_chunks(B: int, channels: int, sm_count: int
                       ) -> tuple[int, int]:
    """``(K, Bc)`` the stream kernel launches with for ``B`` blocks of
    ``channels`` channels on a card of ``sm_count`` SMs: the words
    kernel's rule (the least K that gives every SM
    :data:`~bjxa_tpu_torch.ops.chunking.TARGET_LANES_PER_SM` work items),
    with Bc at least :data:`~bjxa_tpu_torch.ops.chunking.MIN_CHUNK_BLOCKS`
    and a multiple of 4,
    and K = ceil(B / Bc), so no chunk is empty.  Bc a multiple of 4 starts
    every chunk on a 4-byte boundary of the payload (the kernel realigns
    any block, so this is not needed for correctness).  ``B = 0`` gives
    ``(1, 0)``."""
    if B == 0:
        return 1, 0
    want = -(-sm_count * TARGET_LANES_PER_SM // channels)
    Bc = max(MIN_CHUNK_BLOCKS, -(-B // want))
    Bc = -(-Bc // 4) * 4
    return -(-B // Bc), Bc


def _stream_blocks(payload, state, bits: int, channels: int) -> int:
    """Check the stream kernel's arguments; returns the block count B."""
    if bits not in (4, 6, 8):
        raise ValueError(f"fused_decode_stream: bad bit depth {bits}")
    if channels not in (1, 2):
        raise ValueError(f"fused_decode_stream: {channels} channels")
    if payload.dtype != torch.uint8 or state.dtype != torch.int32:
        raise TypeError(
            "fused_decode_stream: want a uint8 payload and an int32 state,"
            f" got {payload.dtype} and {state.dtype}"
        )
    size = channels * (4 * bits + 1)
    if payload.dim() != 1 or payload.numel() % size:
        raise ValueError(
            f"fused_decode_stream: payload {tuple(payload.shape)} is not"
            f" whole blocks of {channels} x {4 * bits + 1} bytes"
        )
    if tuple(state.shape) != (channels, 2):
        raise ValueError(f"fused_decode_stream: state {tuple(state.shape)}"
                         f" != ({channels}, 2)")
    if payload.device != state.device:
        raise ValueError("fused_decode_stream: payload and state on"
                         f" {payload.device} and {state.device}")
    if not (payload.is_contiguous() and state.is_contiguous()):
        raise ValueError("fused_decode_stream: inputs must be contiguous")
    return payload.numel() // size


def _stream_lanes(payload, bits: int, channels: int):
    """The payload as lane-major blocks ``uint8[B, S, C]``."""
    S = 4 * bits + 1
    return payload.view(-1, channels, S).permute(0, 2, 1).contiguous()


def fused_decode_stream_plain(
    payload: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    channels: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the stream kernel, sequential over blocks:
    the payload seen as ``[B, S, C]`` through
    :func:`fused_decode_lanes_plain`.  On any device; it never launches a
    kernel.  Returns ``(frames int16[B*32, C] | None, end int32[C, 2])``."""
    _stream_blocks(payload, state, bits, channels)
    pcm, end = fused_decode_lanes_plain(
        _stream_lanes(payload, bits, channels), state, bits=bits,
        with_output=with_output,
    )
    return (pcm.reshape(-1, channels) if pcm is not None else None), end


def fused_decode_stream_chunked_plain(
    payload: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    channels: int,
    chunks: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the stream kernel's schedule at ``chunks``
    (:func:`chunked_lanes_plain` over the channels as lanes): the CPU
    oracle for the chunk indexing, the short last chunk and the round
    count.  On any device; it never launches a kernel.

    Returns ``(frames int16[B*32, C] | None, end int32[C, 2], rounds)``.
    """
    _stream_blocks(payload, state, bits, channels)
    pcm, end, rounds = chunked_lanes_plain(
        _stream_lanes(payload, bits, channels), state, bits=bits,
        chunks=chunks, with_output=with_output,
    )
    frames = pcm.reshape(-1, channels) if pcm is not None else None
    return frames, end, rounds


@functools.cache
def occupancy(entry: str, *args) -> int:
    """CTAs of a cooperative kernel that fit on one SM at once, from its C
    ``..._occupancy`` entry point called with ``args`` (the last one the
    device index); raises on an error or when none fits."""
    from bjxa_tpu_torch.ops._build import check_launch, library

    n = getattr(library(), entry)(*args)
    check_launch(max(-n, 0), entry)
    if n == 0:
        raise RuntimeError(f"{entry}: no CTA fits on an SM")
    return n


def grid_ctas(items: int, entry: str, *args, device: torch.device) -> int:
    """CTAs of a cooperative launch over ``items`` work items: enough for
    one item a thread, at most what the card holds at once (the
    :func:`occupancy` of ``entry`` with ``args`` times the SMs)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    fit = occupancy(entry, *args, index) * sms
    return max(1, min(-(-items // CTA_THREADS), fit))


def stream_ctas(items: int, *, bits: int, channels: int, with_output: bool,
                device: torch.device) -> int:
    """CTAs of the stream kernel's cooperative launch over ``items`` work
    items (:func:`grid_ctas`)."""
    return grid_ctas(items, "bjxa_decode_stream_occupancy", bits, channels,
                     int(with_output), device=device)


def fused_decode_stream(
    payload: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    channels: int,
    with_output: bool = True,
    chunks: int | None = None,
):
    """Decode one whole stream on the card from its payload bytes (one
    cooperative launch, no host sync).

    Args:
      payload: ``uint8[B*C*S]`` — the XA payload exactly as the file holds
        it (``S = 4*bits + 1``; channel blocks of each block in order),
        starting on a 4-byte boundary.
      state:   ``int32[C, 2]`` — the entry state.
      with_output: False computes only the end state.
      chunks:  forces K (tests and the smoke run); by default
        :func:`pick_stream_chunks` chooses it.

    Returns ``(frames int16[B*32, C] | None, end int32[C, 2], rounds
    int32[1])``: the frames interleaved in the WAV's order, the true end
    state after block B-1, and the kernel's round count, left on the card
    (0 at K = 1).  Profile validity is not checked here.  A non-CUDA
    tensor, a refused launch or a failed build raises; nothing falls back.
    """
    global STREAM_LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    if payload.device.type != "cuda":
        raise ValueError(
            f"fused_decode_stream: no kernel for device {payload.device}"
        )
    B = _stream_blocks(payload, state, bits, channels)
    if payload.data_ptr() % 4:
        raise ValueError("fused_decode_stream: payload must start on a"
                         " 4-byte boundary")
    dev = payload.device
    if chunks is None:
        K, Bc = pick_stream_chunks(
            B, channels,
            torch.cuda.get_device_properties(dev).multi_processor_count,
        )
    else:
        K, Bc = word_chunks(B, chunks)
    frames = (
        torch.empty((B * 32, channels), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    end = torch.empty((channels, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 + (4 * K * channels if K > 1 else 0),
                          dtype=torch.int32, device=dev)
    ctas = stream_ctas(K * channels, bits=bits, channels=channels,
                       with_output=with_output, device=dev)
    err = library().bjxa_decode_stream(
        payload.data_ptr(), state.data_ptr(),
        frames.data_ptr() if frames is not None else None,
        end.data_ptr(), scratch.data_ptr(), B, channels, K, Bc, bits,
        int(with_output), ctas, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "bjxa_decode_stream")
    STREAM_LAUNCHES += 1
    return frames, end, scratch[2:3]
