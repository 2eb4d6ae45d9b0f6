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

import functools

import torch

from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes_plain
from bjxa_tpu_torch.ops.decode import (
    MIN_CHUNK_BLOCKS,
    _fixpoint_states,
    words_to_blocks,
)
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

#: Launches of the words kernel in this process (plain runs never count).
LAUNCHES = 0

#: Threads of a CTA (``kThreads`` in ``csrc/adpcm.cuh``).
CTA_THREADS = 128
#: Lanes an SM needs for the lanes alone to fill the card: one CTA's worth.
#: At and above it K = 1, since every extra round re-reads the input.
FILL_LANES_PER_SM = CTA_THREADS
#: Work items an SM is given below the fill line: K is the least that gives
#: every SM this many (10 warps), keeping
#: :data:`~bjxa_tpu_torch.ops.decode.MIN_CHUNK_BLOCKS` blocks a chunk.  Ten
#: warps an SM keep the loads in flight (the headline runs near its
#: measured bound at 8), and fewer, longer chunks settle in fewer rounds,
#: each of which re-reads the input: on a corpus batch K = B/16 beat B/8
#: and B/32 on the H100 (``PERF.md``, section 6).
TARGET_LANES_PER_SM = 320


def word_chunks(B: int, chunks: int) -> tuple[int, int]:
    """``(K, Bc)`` for ``B`` blocks asked to split into ``chunks``: Bc =
    ceil(B / chunks), and K = ceil(B / Bc), so that no chunk is empty and
    only the last one may be short.  ``B = 0`` gives ``(1, 0)``."""
    if chunks < 1:
        raise ValueError(f"word_chunks: {chunks} chunks")
    if B == 0:
        return 1, 0
    Bc = -(-B // min(chunks, B))
    return -(-B // Bc), Bc


def pick_word_chunks(B: int, L: int, sm_count: int) -> int:
    """The chunk count the wrapper launches with, for ``B`` blocks of ``L``
    lanes on a card of ``sm_count`` SMs: 1 where ``L`` alone fills the card
    (:data:`FILL_LANES_PER_SM`), else the least K that gives each SM
    :data:`TARGET_LANES_PER_SM` work items, at most ``B //
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
    """Plain PyTorch version of the kernel's schedule: the blocks cut into
    :func:`word_chunks` ``(K, Bc)``, the chunks' starts iterated by
    :func:`~bjxa_tpu_torch.ops.decode._fixpoint_states` over the
    sequential plain decode of all ``K*L`` chunk lanes at once (lane
    ``k*L + l``, the kernel's item order; the short last chunk padded with
    profile-0 blocks whose output is dropped), then one run with output.
    K = 1 runs no round.  On any device; it never launches a kernel.

    Returns ``(pcm int16[B, 32, L] | None, end int32[L, 2], rounds)``, the
    same as :func:`fused_decode_words_chunked` with ``rounds`` an int.
    """
    B, W, L = words.shape
    K, Bc = word_chunks(B, chunks)
    if K == 1:
        pcm, end = fused_decode_words_plain(
            prof, words, state, bits=bits, with_output=with_output
        )
        return pcm, end, 0
    pad = K * Bc - B
    cprof = torch.cat([prof, prof.new_zeros((pad, L))])
    cprof = cprof.reshape(K, Bc, L).permute(1, 0, 2).reshape(Bc, K * L)
    cwords = torch.cat([words, words.new_zeros((pad, W, L))])
    cwords = cwords.reshape(K, Bc, W, L).permute(1, 2, 0, 3).reshape(
        Bc, W, K * L
    )

    def run(states_flat, wo):
        return fused_decode_words_plain(
            cprof.contiguous(), cwords.contiguous(), states_flat, bits=bits,
            with_output=wo,
        )

    starts, rounds = _fixpoint_states(run, state.to(torch.int32), K, L,
                                      max_iters=K)
    last = (K - 1) * Bc
    _, end = fused_decode_words_plain(
        prof[last:], words[last:], starts[K - 1].contiguous(), bits=bits,
        with_output=False,
    )
    if not with_output:
        return None, end, rounds
    pcm_l, _ = run(starts.reshape(K * L, 2), True)
    pcm = (
        pcm_l.reshape(Bc, BLOCK_SAMPLES, K, L)
        .permute(2, 0, 1, 3)
        .reshape(K * Bc, BLOCK_SAMPLES, L)[:B]
    )
    return pcm, end, rounds


@functools.cache
def _ctas_per_sm(bits: int, with_output: bool, device: int) -> int:
    from bjxa_tpu_torch.ops._build import check_launch, library

    n = library().bjxa_decode_words_occupancy(bits, int(with_output), device)
    check_launch(max(-n, 0), "bjxa_decode_words_occupancy")
    if n == 0:
        raise RuntimeError("bjxa_decode_words: no CTA fits on an SM")
    return n


def persistent_ctas(items: int, *, bits: int, with_output: bool,
                    device: torch.device) -> int:
    """CTAs of the cooperative launch over ``items`` work items: enough for
    one item a thread, at most what the card holds at once."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    fit = _ctas_per_sm(bits, with_output, index) * sms
    return max(1, min(-(-items // CTA_THREADS), fit))


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
