"""ADPCM prediction filter over unpacked lanes: the CUDA kernel and its
plain twin.

Port of :mod:`bjxa_tpu.ops.pallas_filter`.  The kernel,
``csrc/filter_lanes.cu``, replaces ``pallas_filter._filter_kernel`` (with
output) and ``pallas_filter._states_kernel`` (end state only): the range
shift of already-unpacked int16 samples, then the prediction filter with
int16 saturation.  It is bound by memory bytes where lanes are many and by
the latency of the serial recurrence on the short-stream path (1 or 2
lanes); see the source for the design.

:func:`adpcm_filter_kernel` routes by the tensors' device alone: a CPU
tensor takes :func:`adpcm_filter_plain`, a CUDA tensor launches the
kernel, anything else raises.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.filter import adpcm_filter_lanes, profile_gains

#: Launches of the filter kernel in this process (plain runs never count).
LAUNCHES = 0


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
