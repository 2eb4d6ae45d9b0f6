"""Fused packed-words XA decode over lanes: the CUDA kernel and its plain
twins.

Port of the words half of :mod:`bjxa_tpu.ops.pallas_decode`.  The kernel,
``csrc/decode_words.cu``, replaces ``pallas_decode._decode_words_kernel``
(with output) and ``pallas_decode._words_states_kernel`` (end state only):
the same decode as :mod:`bjxa_tpu_torch.ops.cuda_decode`, with the payload
as little-endian int32 words (word ``w`` = payload bytes ``4w..4w+3`` of
one stream) beside a separate profile plane.

Each lane's blocks are cut into K chunks (:func:`word_chunks`), and the
chunks' entry states are solved exactly inside one cooperative launch:
rounds of the states-only decode until no chunk's start changes, then one
pass with output (see the source).  :func:`pick_word_chunks` chooses K:
1 where the lanes alone fill the card, else enough chunks to give every SM
ten warps of work.  The kernel's round count equals that of
:func:`fused_decode_words_chunked_plain`, the same schedule in plain
PyTorch.

:func:`fused_decode_words` routes by the tensors' device alone: a CPU
tensor takes :func:`fused_decode_words_plain` (the sequential decode), a
CUDA tensor launches the kernel, anything else raises.  Nothing is padded,
so the PCM comes back flat as ``[B, 32, L]`` and the end state is the true
one.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.chunking import (
    CTA_THREADS,
    MIN_CHUNK_BLOCKS,
    TARGET_LANES_PER_SM,
    word_chunks,
)
from bjxa_tpu_torch.ops.cuda_decode import (
    chunked_lanes_plain,
    fused_decode_lanes_plain,
    grid_ctas,
)
from bjxa_tpu_torch.ops.decode import words_to_blocks

#: Launches of the words kernel in this process (plain runs never count).
LAUNCHES = 0

#: Lanes an SM needs for the lanes alone to fill the card: one CTA's worth.
#: At and above it K = 1, since every extra round re-reads the input.
#: Below it each SM gets
#: :data:`~bjxa_tpu_torch.ops.chunking.TARGET_LANES_PER_SM` work items.
FILL_LANES_PER_SM = CTA_THREADS


def pick_word_chunks(B: int, L: int, sm_count: int) -> int:
    """The chunk count the wrapper launches with, for ``B`` blocks of ``L``
    lanes on a card of ``sm_count`` SMs: 1 where ``L`` alone fills the card
    (:data:`FILL_LANES_PER_SM`), else the least K that gives each SM
    :data:`~bjxa_tpu_torch.ops.chunking.TARGET_LANES_PER_SM` work items, at
    most ``B //
    MIN_CHUNK_BLOCKS``, as :func:`word_chunks` leaves it."""
    if L == 0 or L >= sm_count * FILL_LANES_PER_SM:
        return 1
    want = -(-sm_count * TARGET_LANES_PER_SM // L)
    return word_chunks(B, max(1, min(want, B // MIN_CHUNK_BLOCKS)))[0]


def fused_decode_words_plain(
    prof: torch.Tensor,
    words: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the words kernel, sequential over blocks:
    reassemble the raw blocks
    (:func:`~bjxa_tpu_torch.ops.decode.words_to_blocks`), then the lanes
    kernel's plain version.  Same arguments and returns as
    :func:`fused_decode_words`, on any device; it never launches a
    kernel."""
    blocks_t = words_to_blocks(prof, words, bits=bits)
    return fused_decode_lanes_plain(
        blocks_t, state, bits=bits, with_output=with_output
    )


def fused_decode_words_chunked_plain(
    prof: torch.Tensor,
    words: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    chunks: int,
    with_output: bool = True,
):
    """Plain PyTorch version of the kernel's schedule: the raw blocks
    reassembled (:func:`~bjxa_tpu_torch.ops.decode.words_to_blocks`), then
    :func:`~bjxa_tpu_torch.ops.cuda_decode.chunked_lanes_plain` at
    :func:`word_chunks` ``(K, Bc)`` (the chunks' starts solved by the exact
    fixed point, then one run with output; K = 1 runs no round).  On any
    device; it never launches a kernel.

    Returns ``(pcm int16[B, 32, L] | None, end int32[L, 2], rounds)``, the
    same as :func:`fused_decode_words_chunked` with ``rounds`` an int.
    """
    return chunked_lanes_plain(
        words_to_blocks(prof, words, bits=bits), state, bits=bits,
        chunks=chunks, with_output=with_output,
    )


def persistent_ctas(items: int, *, bits: int, with_output: bool,
                    device: torch.device) -> int:
    """CTAs of the cooperative launch over ``items`` work items: enough for
    one item a thread, at most what the card holds at once."""
    return grid_ctas(items, "bjxa_decode_words_occupancy", bits,
                     int(with_output), device=device)


def _check(prof, words, state, bits):
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
    return B, L


def fused_decode_words_chunked(
    prof: torch.Tensor,
    words: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    with_output: bool = True,
    chunks: int | None = None,
):
    """Launch the words kernel on CUDA tensors (one cooperative launch, no
    host sync).  ``chunks`` forces K (tests and the smoke run); by default
    :func:`pick_word_chunks` chooses it.

    Returns ``(pcm int16[B, 32, L] | None, end int32[L, 2], rounds
    int32[1])``: ``rounds`` stays on the card, where the kernel wrote its
    round count (0 at K = 1).  A refused launch or a failed build raises;
    nothing falls back.
    """
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    if words.device.type != "cuda":
        raise ValueError(
            f"fused_decode_words: no kernel for device {words.device}"
        )
    B, L = _check(prof, words, state, bits)
    dev = words.device
    if chunks is None:
        chunks = pick_word_chunks(
            B, L, torch.cuda.get_device_properties(dev).multi_processor_count
        )
    K, Bc = word_chunks(B, chunks)
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    pcm = (
        torch.empty((B, 32, L), dtype=torch.int16, device=dev)
        if with_output
        else None
    )
    scratch = torch.empty(4 + (4 * K * L if K > 1 else 0), dtype=torch.int32,
                          device=dev)
    if L == 0:
        scratch[2] = 0
        return pcm, end, scratch[2:3]
    ctas = persistent_ctas(K * L, bits=bits, with_output=with_output,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().bjxa_decode_words(
        prof.data_ptr(), words.data_ptr(), state.data_ptr(),
        pcm.data_ptr() if pcm is not None else None, end.data_ptr(),
        scratch.data_ptr(), B, L, K, Bc, bits, int(with_output), ctas,
        dev.index, stream,
    )
    check_launch(err, "bjxa_decode_words")
    LAUNCHES += 1
    return pcm, end, scratch[2:3]


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
    pcm, end, _rounds = fused_decode_words_chunked(
        prof, words, state, bits=bits, with_output=with_output
    )
    return pcm, end
