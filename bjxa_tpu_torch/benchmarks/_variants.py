"""What the load-variant and store-variant scripts share: the store forms,
the launch of ``csrc/decode_variants.cu`` (the words kernel's chunk schedule
and launch with one load or store policy swapped) and the repack of plain
PCM into a store form."""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.chunking import word_chunks
from bjxa_tpu_torch.ops.cuda_decode import grid_ctas
from bjxa_tpu_torch.ops.cuda_decode_words import pick_word_chunks
from bjxa_tpu_torch.ops.decode import _sign_extend_32
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

BITS = 8  # the variants decode 8-bit streams only
LOADS = {"u8": 0, "w32": 1}
#: store form -> (code, rows per block, element type)
STORES = {
    "i16": (0, BLOCK_SAMPLES, torch.int16),
    "i32": (1, BLOCK_SAMPLES, torch.int32),
    "pair": (2, BLOCK_SAMPLES // 2, torch.int32),
}


def repack(pcm: torch.Tensor, store: str) -> torch.Tensor:
    """Plain ``int16[B, 32, L]`` PCM in a store form: ``i16`` as it is,
    ``i32`` widened, ``pair`` two consecutive samples a word,
    ``(s0 & 0xFFFF) | (s1 << 16)`` as ``int32[B, 16, L]``.  The pairs are
    packed in int64 and narrowed: torch has no ``uint32`` shifts."""
    if store == "i16":
        return pcm
    if store == "i32":
        return pcm.to(torch.int32)
    if store != "pair":
        raise ValueError(f"unknown store form {store!r}")
    s = pcm.to(torch.int64) & 0xFFFF
    return _sign_extend_32(s[:, 0::2, :] | (s[:, 1::2, :] << 16))


def pair_to_i16(out: torch.Tensor) -> torch.Tensor:
    """The little-endian int16 view of a ``pair`` output, as
    ``int16[B, 32, L]``: the natural sample order of every lane."""
    B, rows, L = out.shape
    halves = out.contiguous().view(torch.int16).reshape(B, rows, L, 2)
    return halves.permute(0, 1, 3, 2).reshape(B, 2 * rows, L)


def launch_variant(name: str, load: str, store: str, first: torch.Tensor,
                   words: torch.Tensor | None, state: torch.Tensor, *,
                   chunks: int | None = None):
    """Check the inputs and launch one instantiation of the variants
    kernel on their CUDA device: one cooperative launch, no host sync.
    ``first`` is ``blocks_t uint8[B, 33, L]`` (load ``u8``) or ``prof
    uint8[B, L]`` beside ``words int32[B, 8, L]`` (load ``w32``).  K is
    the words kernel's: ``chunks`` forces it (tests and the smoke run),
    else :func:`~bjxa_tpu_torch.ops.cuda_decode_words.pick_word_chunks`
    chooses it; the grid is :func:`~bjxa_tpu_torch.ops.cuda_decode.grid_ctas` of the
    instantiation's occupancy.

    Returns ``(out, end int32[L, 2], rounds int32[1])``, ``rounds`` left on
    the card where the kernel wrote its round count (0 at K = 1).  A refused
    launch or a failed build raises; nothing falls back.
    """
    from bjxa_tpu_torch.ops._build import check_launch, library

    if store not in STORES or load not in LOADS or (load, store) == (
            "w32", "i32"):
        raise ValueError(f"{name}: no {load} x {store} instantiation")
    code, rows, dtype = STORES[store]
    if load == "u8":
        if first.dim() != 3 or first.shape[1] != 4 * BITS + 1:
            raise ValueError(f"{name}: blocks {tuple(first.shape)} is not"
                             f" [B, {4 * BITS + 1}, L]")
        B, _S, L = first.shape
        tensors = (first, state)
    else:
        if words.dim() != 3 or words.shape[1] != BITS:
            raise ValueError(f"{name}: words {tuple(words.shape)} is not"
                             f" [B, {BITS}, L]")
        B, _W, L = words.shape
        if tuple(first.shape) != (B, L):
            raise ValueError(f"{name}: prof {tuple(first.shape)} for B={B},"
                             f" L={L}")
        if words.dtype != torch.int32:
            raise TypeError(f"{name}: want int32 words, got {words.dtype}")
        tensors = (first, words, state)
    if first.dtype != torch.uint8 or state.dtype != torch.int32:
        raise TypeError(f"{name}: want uint8 bytes and int32 state, got"
                        f" {first.dtype} and {state.dtype}")
    if L == 0 or tuple(state.shape) != (L, 2):
        raise ValueError(f"{name}: state {tuple(state.shape)} for {L} lanes")
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    dev = first.device
    if chunks is None:
        chunks = pick_word_chunks(
            B, L, torch.cuda.get_device_properties(dev).multi_processor_count)
    K, Bc = word_chunks(B, chunks)
    out = torch.empty((B, rows, L), dtype=dtype, device=dev)
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 + (4 * K * L if K > 1 else 0), dtype=torch.int32,
                          device=dev)
    ctas = grid_ctas(K * L, "bjxa_decode_variant_occupancy", LOADS[load],
                     code, device=dev)
    err = library().bjxa_decode_variant(
        first.data_ptr(), words.data_ptr() if words is not None else None,
        state.data_ptr(), out.data_ptr(), end.data_ptr(), scratch.data_ptr(),
        B, L, K, Bc, LOADS[load], code, ctas, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "bjxa_decode_variant")
    return out, end, scratch[2:3]
