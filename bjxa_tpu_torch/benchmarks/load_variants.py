"""Micro-bench: load-side variants of the fused 8-bit decode kernel.

Port of ``benchmarks/bench_load_variants.py``.  It measures whether feeding
the payload as packed int32 words (4 consecutive payload bytes of the SAME
stream per word, bytes taken by shift and mask; lane and state semantics
unchanged) beats one uint8 load per sample:

  load w32 : profile ``uint8[B, L]`` + payload ``int32[B, 8, L]``

crossed with the store forms

  store i16  : int16 per-sample store
  store pair : two consecutive samples packed into one int32 word
               (``(s0 & 0xFFFF) | (s1 << 16)``); half the stores

The kernel, ``csrc/decode_variants.cu`` (its ``w32`` instantiations),
replaces ``bench_load_variants._kernel``.  It is the words kernel's chunk
schedule and chunk body (``csrc/decode_chunk.cuh``) with the store policy
swapped, so ``w32`` + ``i16`` is the words kernel itself, and it launches
at the words kernel's K (:func:`decode_w32_chunked` forces K and returns
the rounds); its production counterparts are the words kernel and the
lanes kernel.  Every variant is checked bit-exact against both before it
is timed.

    python -m bjxa_tpu_torch.benchmarks.load_variants

Env: ``BENCH_LANES`` (32,768), ``BENCH_BLOCKS`` (64), ``BENCH_REPS``; a
corpus batch, the shape corpus runs launch, is ``BENCH_LANES=32
BENCH_BLOCKS=20736``.  One
JSON line per variant and per production kernel, in Gsamples/s.
:func:`~bjxa_tpu_torch.ops.decode.pack_words_from_lanes` is the port of
``pack_words``.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.benchmarks import _variants
from bjxa_tpu_torch.benchmarks._common import (
    bench_device,
    emit,
    env_int,
    random_lanes,
    time_ms,
)
from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes
from bjxa_tpu_torch.ops.cuda_decode_words import (
    fused_decode_words,
    fused_decode_words_chunked_plain,
    fused_decode_words_plain,
)
from bjxa_tpu_torch.ops.decode import pack_words_from_lanes
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

#: Launches of the w32 variants in this process (plain runs never count).
LAUNCHES = 0
STORES = ("i16", "pair")


def decode_w32_plain(prof: torch.Tensor, words: torch.Tensor,
                     state: torch.Tensor, *, store: str):
    """Plain PyTorch version of the ``w32`` variants: the words kernel's
    plain version, then the repack into the store form.  Same arguments and
    returns as :func:`decode_w32`, on any device."""
    if store not in STORES:
        raise ValueError(f"decode_w32: no w32 x {store} instantiation")
    pcm, end = fused_decode_words_plain(prof, words, state,
                                        bits=_variants.BITS)
    return _variants.repack(pcm, store), end


def decode_w32_chunked_plain(prof: torch.Tensor, words: torch.Tensor,
                             state: torch.Tensor, *, store: str,
                             chunks: int):
    """Plain PyTorch version of the kernel's schedule at ``chunks``: the
    words kernel's chunked plain version
    (:func:`fused_decode_words_chunked_plain`), then the repack into the
    store form.  On any device.

    Returns ``(out, end int32[L, 2], rounds)``, ``rounds`` an int."""
    if store not in STORES:
        raise ValueError(f"decode_w32: no w32 x {store} instantiation")
    pcm, end, rounds = fused_decode_words_chunked_plain(
        prof, words, state, bits=_variants.BITS, chunks=chunks)
    return _variants.repack(pcm, store), end, rounds


def decode_w32_chunked(prof: torch.Tensor, words: torch.Tensor,
                       state: torch.Tensor, *, store: str,
                       chunks: int | None = None):
    """Launch a ``w32`` variant on CUDA tensors (one cooperative launch, no
    host sync) at the words kernel's K, or at ``chunks`` where given.

    Returns ``(out, end int32[L, 2], rounds int32[1])``, ``rounds`` left on
    the card.  A non-CUDA tensor, a refused launch or a failed build
    raises; nothing falls back.
    """
    global LAUNCHES
    if words.device.type != "cuda":
        raise ValueError(f"decode_w32: no kernel for device {words.device}")
    if store not in STORES:
        raise ValueError(f"decode_w32: no w32 x {store} instantiation")
    out = _variants.launch_variant("decode_w32", "w32", store, prof, words,
                                   state, chunks=chunks)
    LAUNCHES += 1
    return out


def decode_w32(prof: torch.Tensor, words: torch.Tensor, state: torch.Tensor,
               *, store: str):
    """Decode 8-bit packed-words blocks, storing in form ``store``.

    Args:
      prof:  ``uint8[B, L]``; words: ``int32[B, 8, L]``;
      state: ``int32[L, 2]``; store: ``"i16"`` or ``"pair"``.

    Returns ``(out, end int32[L, 2])`` with ``out`` ``int16[B, 32, L]`` or
    ``int32[B, 16, L]``.  Routes by the tensors' device alone: a CPU tensor
    takes :func:`decode_w32_plain`, a CUDA tensor launches the kernel
    (:func:`decode_w32_chunked`), anything else raises.
    """
    if words.device.type == "cpu":
        return decode_w32_plain(prof, words, state, store=store)
    out, end, _rounds = decode_w32_chunked(prof, words, state, store=store)
    return out, end


def check_variants(blocks_t, prof, words, state) -> None:
    """Every w32 variant equals the production kernels on these inputs."""
    ref_pcm, ref_end = fused_decode_words(prof, words, state,
                                          bits=_variants.BITS)
    lanes_pcm, lanes_end = fused_decode_lanes(blocks_t, state,
                                              bits=_variants.BITS)
    got, got_end = decode_w32(prof, words, state, store="i16")
    pair, pair_end = decode_w32(prof, words, state, store="pair")
    for name, a, b in (
        ("w32+i16 vs words kernel", got, ref_pcm),
        ("w32+i16 vs lanes kernel", got, lanes_pcm),
        ("w32+pair int16 view", _variants.pair_to_i16(pair), ref_pcm),
        ("w32+i16 end", got_end, ref_end),
        ("lanes kernel end", lanes_end, ref_end),
        ("w32+pair end", pair_end, ref_end),
    ):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"load variants: {name} differs")


def main() -> list[dict]:
    device = bench_device()
    lanes = env_int("BENCH_LANES", 32768)
    blocks = env_int("BENCH_BLOCKS", 64)
    reps = env_int("BENCH_REPS", 10)
    blocks_t = random_lanes(7, blocks, lanes, _variants.BITS, device)
    state = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
    prof, words = pack_words_from_lanes(blocks_t, bits=_variants.BITS)
    check_variants(blocks_t, prof, words, state)

    samples = lanes * blocks * BLOCK_SAMPLES
    runs = [(f"w32+{store}", lambda store=store: decode_w32(
        prof, words, state, store=store)) for store in STORES]
    runs.append(("production words kernel", lambda: fused_decode_words(
        prof, words, state, bits=_variants.BITS)))
    runs.append(("production lanes kernel", lambda: fused_decode_lanes(
        blocks_t, state, bits=_variants.BITS)))
    out = []
    for name, fn in runs:
        ms = time_ms(fn, device, reps=reps)
        out.append(emit({
            "metric": "load_variant_rate", "variant": name,
            "value": round(samples / ms / 1e6, 3), "unit": "Gsamples/s",
            "ms": round(ms, 6), "bit_exact": True, "lanes": lanes,
            "blocks": blocks, "launches": LAUNCHES,
        }, device))
    return out


if __name__ == "__main__":
    main()
