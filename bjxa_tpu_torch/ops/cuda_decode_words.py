"""Fused packed-words XA decode over lanes: the CUDA kernel and its plain
twin.

Port of the words half of :mod:`bjxa_tpu.ops.pallas_decode`.  The kernel,
``csrc/decode_words.cu``, replaces ``pallas_decode._decode_words_kernel``
(with output) and ``pallas_decode._words_states_kernel`` (end state only):
the same decode as :mod:`bjxa_tpu_torch.ops.cuda_decode`, with the payload
as little-endian int32 words (word ``w`` = payload bytes ``4w..4w+3`` of
one stream) beside a separate profile plane.  It is bound by memory bytes
(``bits/8 + 1/32`` B read and 2 B written per sample) where lanes are
many, and by the latency of its serial block loop where they are few (a
corpus batch); see the source.

:func:`fused_decode_words` routes by the tensors' device alone: a CPU
tensor takes :func:`fused_decode_words_plain`, a CUDA tensor launches the
kernel, anything else raises.  Lanes and blocks are not padded (the kernel
bounds-checks its lane and loops over every block), so the PCM comes back
flat as ``[B, 32, L]`` and the end state is the true one.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes_plain
from bjxa_tpu_torch.ops.decode import words_to_blocks

#: Launches of the words kernel in this process (plain runs never count).
LAUNCHES = 0


def fused_decode_words_plain(
    prof: torch.Tensor,
    words: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the words kernel: reassemble the raw blocks
    (:func:`~bjxa_tpu_torch.ops.decode.words_to_blocks`), then the lanes
    kernel's plain version.  Same arguments and returns as
    :func:`fused_decode_words`, on any device; it never launches a
    kernel."""
    blocks_t = words_to_blocks(prof, words, bits=bits)
    return fused_decode_lanes_plain(
        blocks_t, state, bits=bits, with_output=with_output
    )


def _launch(prof, words, state, *, bits, with_output):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    if bits not in (4, 6, 8):
        raise ValueError(f"fused_decode_words: bad bit depth {bits}")
    if words.dim() != 3 or words.shape[1] != bits:
        raise ValueError(f"fused_decode_words: words {tuple(words.shape)} is"
                         f" not [B, {bits}, L]")
    B, _W, L = words.shape
    if (prof.dtype != torch.uint8 or words.dtype != torch.int32
            or state.dtype != torch.int32):
        raise TypeError(
            "fused_decode_words: want uint8 prof, int32 words and int32"
            f" state, got {prof.dtype}, {words.dtype} and {state.dtype}"
        )
    if tuple(prof.shape) != (B, L) or tuple(state.shape) != (L, 2):
        raise ValueError(f"fused_decode_words: prof {tuple(prof.shape)} and"
                         f" state {tuple(state.shape)} for B={B}, L={L}")
    if not (prof.device == words.device == state.device):
        raise ValueError("fused_decode_words: prof, words and state on"
                         f" {prof.device}, {words.device} and {state.device}")
    if not (prof.is_contiguous() and words.is_contiguous()
            and state.is_contiguous()):
        raise ValueError("fused_decode_words: inputs must be contiguous")
    dev = words.device
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    pcm = (
        torch.empty((B, 32, L), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    if L == 0:
        return pcm, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().bjxa_decode_words(
        prof.data_ptr(), words.data_ptr(), state.data_ptr(),
        pcm.data_ptr() if pcm is not None else None, end.data_ptr(),
        B, L, bits, int(with_output), dev.index, stream,
    )
    check_launch(err, "bjxa_decode_words")
    LAUNCHES += 1
    return pcm, end


def fused_decode_words(
    prof: torch.Tensor,
    words: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Decode packed-words lane-major blocks.

    Args:
      prof:  ``uint8[B, L]`` — profile byte per block per lane.
      words: ``int32[B, bits, L]`` — payload as little-endian int32 words
        (word ``w`` packs payload bytes ``4w..4w+3`` of one stream).
      state: ``int32[L, 2]`` — (prev0, prev1) per lane.
      with_output: False computes only the end state.

    Returns ``(pcm int16[B, 32, L] | None, end_state int32[L, 2])``,
    bit-exact with every other decode path; profile validity is not
    checked here (callers derive it from the profile bytes).
    """
    if words.device.type == "cpu":
        return fused_decode_words_plain(
            prof, words, state, bits=bits, with_output=with_output
        )
    if words.device.type != "cuda":
        raise ValueError(
            f"fused_decode_words: no kernel for device {words.device}"
        )
    return _launch(prof, words, state, bits=bits, with_output=with_output)
