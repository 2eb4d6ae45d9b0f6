"""ADPCM prediction filter of short streams and over unpacked lanes: the
CUDA kernels and their plain twins.

Port of :mod:`bjxa_tpu.ops.pallas_filter`.  ``csrc/filter_lanes.cu``
replaces ``pallas_filter._filter_kernel`` (with output) and
``pallas_filter._states_kernel`` (end state only) through two entries:

* :func:`fused_decode_short` -- the whole of ``decode_arrays`` for one
  short stream in ONE launch: raw blocks ``uint8[C, B, S]`` in,
  interleaved frames, end state and validity out.  One CTA stages the
  stream in shared memory, unpacks every sample in parallel and runs the
  recurrence as K chunks a channel solved by the exact fixed point of
  ``csrc/chunk_fixpoint.cuh`` (:func:`pick_short_chunks`).  The short
  stream's path on the card (:func:`bjxa_tpu_torch.ops.decode.
  decode_arrays`).
* :func:`adpcm_filter_kernel` -- the TPU kernels' own contract: the range
  shift of already-unpacked int16 samples, then the filter.  Few lanes take
  the same one-CTA body, many lanes one thread per lane.

Both are bound by the latency of the serial recurrence on a short stream
and by memory bytes where lanes are many; see the source for the design.

Each wrapper routes by the tensors' device alone: a CPU tensor takes the
plain version (:func:`decode_short_plain`, :func:`adpcm_filter_plain`), a
CUDA tensor launches the kernel, anything else raises.
:func:`decode_short_chunked_plain` is the fused kernel's schedule in plain
PyTorch, round count included.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.chunking import pick_short_chunks, word_chunks
from bjxa_tpu_torch.ops.filter import adpcm_filter_lanes, profile_gains
from bjxa_tpu_torch.ops.inflate import inflate_blocks

#: Launches of the samples entry (``bjxa_filter_lanes``) in this process
#: (plain runs never count).
LAUNCHES = 0
#: Launches of the fused short-stream entry (``bjxa_decode_short``) in this
#: process (plain runs never count).
SHORT_LAUNCHES = 0


def adpcm_filter_plain(
    samples: torch.Tensor,
    k0: torch.Tensor,
    k1: torch.Tensor,
    shift: torch.Tensor,
    state: torch.Tensor,
    *,
    with_output: bool = True,
):
    """Plain PyTorch version of the filter kernel (range shift, then
    :func:`adpcm_filter_lanes`).  Same arguments and returns as
    :func:`adpcm_filter_kernel`, on any device."""
    ranged = samples.to(torch.int32) >> shift[:, None, :]
    return adpcm_filter_lanes(ranged, k0, k1, state, with_output=with_output)


def _launch(samples, k0, k1, shift, state, *, with_output):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    B, ns, L = samples.shape
    if ns != 32:
        raise ValueError(f"adpcm_filter_kernel: {ns} samples per block != 32")
    if samples.dtype != torch.int16:
        raise TypeError(f"adpcm_filter_kernel: samples are {samples.dtype},"
                        " want int16")
    for name, t, shape in (("k0", k0, (B, L)), ("k1", k1, (B, L)),
                           ("shift", shift, (B, L)), ("state", state, (L, 2))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"adpcm_filter_kernel: {name} is {t.dtype}{list(t.shape)},"
                f" want torch.int32{list(shape)}"
            )
        if t.device != samples.device:
            raise ValueError(f"adpcm_filter_kernel: {name} on {t.device},"
                             f" samples on {samples.device}")
    if not all(t.is_contiguous() for t in (samples, k0, k1, shift, state)):
        raise ValueError("adpcm_filter_kernel: inputs must be contiguous")
    dev = samples.device
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    pcm = (
        torch.empty((B, 32, L), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    if L == 0:
        return pcm, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().bjxa_filter_lanes(
        samples.data_ptr(), k0.data_ptr(), k1.data_ptr(), shift.data_ptr(),
        state.data_ptr(), pcm.data_ptr() if pcm is not None else None,
        end.data_ptr(), B, L, int(with_output), dev.index, stream,
    )
    check_launch(err, "bjxa_filter_lanes")
    LAUNCHES += 1
    return pcm, end


def adpcm_filter_kernel(
    samples: torch.Tensor,
    k0: torch.Tensor,
    k1: torch.Tensor,
    shift: torch.Tensor,
    state: torch.Tensor,
    *,
    with_output: bool = True,
):
    """Run the prediction filter over all lanes.

    Args:
      samples: ``int16[B, 32, L]`` — unpacked top-bits sample values
        (NOT yet range-shifted; the shift happens in the kernel).
      k0, k1:  ``int32[B, L]`` — per-block gains per lane.
      shift:   ``int32[B, L]`` — per-block range per lane.
      state:   ``int32[L, 2]`` — (prev0, prev1) per lane.

    Returns ``(pcm int16[B, 32, L] | None, end_state int32[L, 2])``.
    """
    if samples.device.type == "cpu":
        return adpcm_filter_plain(
            samples, k0, k1, shift, state, with_output=with_output
        )
    if samples.device.type != "cuda":
        raise ValueError(
            f"adpcm_filter_kernel: no kernel for device {samples.device}"
        )
    return _launch(samples, k0, k1, shift, state, with_output=with_output)


def decode_lanes_kernel(
    profiles: torch.Tensor,
    samples: torch.Tensor,
    state: torch.Tensor,
    with_output: bool = True,
):
    """Twin of :func:`bjxa_tpu.ops.pallas_filter.decode_lanes_pallas`:
    profile decode in PyTorch, then :func:`adpcm_filter_kernel` (which
    takes the plain version for CPU tensors).  No tile padding, so the
    kernel's end state is exact as it stands.

    Args/returns match :func:`bjxa_tpu_torch.ops.filter.decode_lanes`:
    ``(pcm int16[B,32,L] | None, end int32[L,2], valid bool[B,L])``.
    """
    k0, k1, shift, valid = profile_gains(profiles)
    pcm, end = adpcm_filter_kernel(
        samples.to(torch.int16).contiguous(),
        k0.contiguous(),
        k1.contiguous(),
        shift.contiguous(),
        state.to(torch.int32).contiguous(),
        with_output=with_output,
    )
    return pcm, end, valid


# --------------------------------------------------------------------------
# the fused short-stream entry: decode_arrays in one launch
# --------------------------------------------------------------------------


def _short_blocks(blocks, state, bits: int) -> tuple[int, int]:
    """Check the fused entry's arguments; returns ``(C, B)``."""
    if bits not in (4, 6, 8):
        raise ValueError(f"fused_decode_short: bad bit depth {bits}")
    if blocks.dtype != torch.uint8 or state.dtype != torch.int32:
        raise TypeError(
            "fused_decode_short: want uint8 blocks and an int32 state, got"
            f" {blocks.dtype} and {state.dtype}"
        )
    if blocks.dim() != 3 or blocks.shape[2] != 4 * bits + 1:
        raise ValueError(
            f"fused_decode_short: blocks {tuple(blocks.shape)} are not"
            f" [C, B, {4 * bits + 1}]"
        )
    C, B, _S = blocks.shape
    if C < 1 or tuple(state.shape) != (C, 2):
        raise ValueError(f"fused_decode_short: state {tuple(state.shape)}"
                         f" for {C} channels")
    if blocks.device != state.device:
        raise ValueError("fused_decode_short: blocks and state on"
                         f" {blocks.device} and {state.device}")
    if not (blocks.is_contiguous() and state.is_contiguous()):
        raise ValueError("fused_decode_short: inputs must be contiguous")
    return C, B


def decode_short_plain(
    blocks: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the fused entry, sequential over blocks:
    :func:`~bjxa_tpu_torch.ops.inflate.inflate_blocks`, the gains, then
    :func:`adpcm_filter_plain` -- what ``decode_arrays`` computes on the
    CPU.  On any device; it never launches a kernel.

    Returns ``(frames int16[B*32, C] | None, end int32[C, 2],
    valid bool[B, C])``.
    """
    C, _B = _short_blocks(blocks, state, bits)
    profiles, samples = inflate_blocks(blocks, bits)  # [C, B], [C, B, 32]
    k0, k1, shift, valid = profile_gains(profiles.transpose(0, 1))
    pcm, end = adpcm_filter_plain(samples.permute(1, 2, 0), k0, k1, shift,
                                  state, with_output=with_output)
    return (pcm.reshape(-1, C) if pcm is not None else None), end, valid


def decode_short_chunked_plain(
    blocks: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    chunks: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the fused entry's schedule at ``chunks``
    (:func:`~bjxa_tpu_torch.ops.cuda_decode.chunked_lanes_plain` over the
    channels as lanes, whose rounds are
    :func:`~bjxa_tpu_torch.ops.chunking.fixpoint_states`'): the CPU oracle
    for the chunk indexing, the short last chunk and the round count.  On
    any device; it never launches a kernel.

    Returns ``(frames int16[B*32, C] | None, end int32[C, 2],
    valid bool[B, C], rounds)``.
    """
    # cuda_decode imports this module: import it at call time
    from bjxa_tpu_torch.ops.cuda_decode import chunked_lanes_plain

    C, _B = _short_blocks(blocks, state, bits)
    pcm, end, rounds = chunked_lanes_plain(
        blocks.permute(1, 2, 0), state, bits=bits, chunks=chunks,
        with_output=with_output,
    )
    valid = (blocks[:, :, 0] >> 4).transpose(0, 1) < 5
    frames = pcm.reshape(-1, C) if pcm is not None else None
    return frames, end, valid, rounds


def _launch_short(blocks, state, *, bits, with_output, chunks):
    global SHORT_LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    C, B = _short_blocks(blocks, state, bits)
    K, Bc = pick_short_chunks(B) if chunks is None else word_chunks(B, chunks)
    dev = blocks.device
    frames = (
        torch.empty((B * 32, C), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    end = torch.empty((C, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    rounds = torch.empty(1, dtype=torch.int32, device=dev)
    err = library().bjxa_decode_short(
        blocks.data_ptr(), state.data_ptr(),
        frames.data_ptr() if frames is not None else None, end.data_ptr(),
        valid.data_ptr(), rounds.data_ptr(), B, C, K, Bc, bits,
        int(with_output), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "bjxa_decode_short")
    SHORT_LAUNCHES += 1
    return frames, end, valid, rounds


def fused_decode_short(
    blocks: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
    chunks: int | None = None,
):
    """Decode one short stream from its raw blocks (one launch, one CTA).

    Args:
      blocks: ``uint8[C, B, 4*bits + 1]`` -- raw XA blocks per channel
        (the layout of ``decode_arrays``).
      state:  ``int32[C, 2]`` -- the entry state.
      with_output: False computes only the end state (and the validity).
      chunks: forces K (tests and the smoke run); by default
        :func:`~bjxa_tpu_torch.ops.chunking.pick_short_chunks` chooses it.

    Returns ``(frames int16[B*32, C] | None, end int32[C, 2],
    valid bool[B, C], rounds int32[1])``: the frames interleaved in the
    WAV's order and the kernel's round count, left on the device (the CPU's
    plain version runs the blocks in order: 0 rounds).  The kernel's shared
    memory grows with ``B x C`` (136 bytes each); a stream past the card's
    limit is refused and raises, as does a non-CUDA device.  Nothing falls
    back.
    """
    if blocks.device.type == "cpu":
        frames, end, valid = decode_short_plain(
            blocks, state, bits=bits, with_output=with_output
        )
        return frames, end, valid, torch.zeros(1, dtype=torch.int32)
    if blocks.device.type != "cuda":
        raise ValueError(
            f"fused_decode_short: no kernel for device {blocks.device}"
        )
    return _launch_short(blocks, state, bits=bits, with_output=with_output,
                         chunks=chunks)


def empty_launch(device: torch.device) -> None:
    """One launch of a kernel that does nothing (``bjxa_empty_launch``) on
    the current stream: the launch floor the timings hold the short-stream
    kernels against.  CUDA only."""
    from bjxa_tpu_torch.ops._build import check_launch, library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_launch: no kernel for device {device}")
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    err = library().bjxa_empty_launch(
        index, torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "bjxa_empty_launch")
