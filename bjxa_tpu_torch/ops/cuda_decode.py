"""Fused raw-bytes XA decode over lanes: the CUDA kernel and its plain twin.

Port of :mod:`bjxa_tpu.ops.pallas_decode` (lanes layout only).  The kernel,
``csrc/decode_lanes.cu``, replaces ``pallas_decode._decode_kernel`` (with
output) and ``pallas_decode._states_kernel`` (end state only): profile
decode, gain select, 4/6/8-bit unpack, range shift and the prediction
filter in one pass over the raw block bytes.  It is bound by memory bytes
(``bits/8 + 1/32`` B read and 2 B written per sample); see the source for
how its one-thread-per-lane design answers that on Hopper.

:func:`fused_decode_lanes` routes by the tensors' device alone: a CPU
tensor takes :func:`fused_decode_lanes_plain`, a CUDA tensor launches the
kernel, anything else raises.  No lane or block padding is needed: the
kernel bounds-checks its lane and loops over every block.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.cuda_filter import adpcm_filter_plain
from bjxa_tpu_torch.ops.filter import profile_gains
from bjxa_tpu_torch.ops.inflate import inflate_lanes

#: Launches of the decode kernel in this process (plain runs never count).
LAUNCHES = 0


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
