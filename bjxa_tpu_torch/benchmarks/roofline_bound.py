"""Measured roofline denominator of the packed-words decode: a load/store
only kernel at the words decode's shape, layout, launch and loads (the
words kernel's ``cp.async`` ring at K = 1), the filter replaced by one add
per store, giving the bandwidth a memory-bound kernel of identical traffic
sustains on this card.

Port of ``benchmarks/bench_roofline_bound.py``.  The kernel,
``csrc/loadstore_bound.cu``, replaces its ``_null_kernel``; the words decode
is then stated as a share of a *measured* bound beside the card's published
memory rate.

    python -m bjxa_tpu_torch.benchmarks.roofline_bound

Env: ``BENCH_BITS`` (default: 4, 6 and 8 in turn), ``BENCH_FILES``,
``BENCH_BLOCKS`` (headline-shape defaults: 16,384 stereo files x 64 blocks),
``BENCH_REPS``.  One JSON line per bit depth: the bound in Msamples/s and
GB/s, and the words decode kernel's time on the same inputs as a share of it.
"""

from __future__ import annotations

import os

import torch

from bjxa_tpu_torch.benchmarks._common import (
    bench_device,
    emit,
    env_int,
    time_ms,
)
from bjxa_tpu_torch.ops.cuda_decode import grid_ctas
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

#: Launches of the load/store kernel in this process (plain runs never count).
LAUNCHES = 0


def _wrap(x: torch.Tensor, width: int) -> torch.Tensor:
    """int64 values -> the signed ``width``-bit integer with the same low
    bits (two's complement wraparound), still int64."""
    half = 1 << (width - 1)
    return ((x + half) & ((1 << width) - 1)) - half


def null_decode_plain(prof: torch.Tensor, words: torch.Tensor,
                      state: torch.Tensor):
    """Plain PyTorch version of the load/store kernel, on any device.

    Per block and lane ``base = prof + sum(words)`` wrapping in int32,
    ``out[b, n, l] = int16(base + n)`` truncating, and ``end[:, 0] =
    state[:, 0] + sum_b base`` wrapping; ``end[:, 1] = state[:, 1]``.  The
    arithmetic is int64 narrowed by hand: torch has no wrapping guarantee
    for signed overflow.  Same arguments and returns as :func:`null_decode`.
    """
    base = _wrap(prof.to(torch.int64) + words.to(torch.int64).sum(dim=1), 32)
    n = torch.arange(BLOCK_SAMPLES, device=words.device)[None, :, None]
    out = _wrap(base[:, None, :] + n, 16).to(torch.int16)
    end = state.clone()
    end[:, 0] = _wrap(state[:, 0].to(torch.int64) + base.sum(dim=0), 32).to(
        torch.int32
    )
    return out, end


def _launch(prof, words, state):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    if words.dim() != 3 or words.shape[1] not in (4, 6, 8):
        raise ValueError(f"null_decode: words {tuple(words.shape)} is not"
                         " [B, 4|6|8, L]")
    B, bits, L = words.shape
    if (prof.dtype != torch.uint8 or words.dtype != torch.int32
            or state.dtype != torch.int32):
        raise TypeError(
            "null_decode: want uint8 prof, int32 words and int32 state, got"
            f" {prof.dtype}, {words.dtype} and {state.dtype}"
        )
    if tuple(prof.shape) != (B, L) or tuple(state.shape) != (L, 2):
        raise ValueError(f"null_decode: prof {tuple(prof.shape)} and state"
                         f" {tuple(state.shape)} for B={B}, L={L}")
    if not (prof.device == words.device == state.device):
        raise ValueError("null_decode: prof, words and state on"
                         f" {prof.device}, {words.device} and {state.device}")
    if not (prof.is_contiguous() and words.is_contiguous()
            and state.is_contiguous()):
        raise ValueError("null_decode: inputs must be contiguous")
    dev = words.device
    out = torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev)
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    if L == 0:
        return out, end
    # the words kernel's launch at K = 1: a persistent cooperative grid
    scratch = torch.empty(4, dtype=torch.int32, device=dev)
    ctas = grid_ctas(L, "bjxa_loadstore_bound_occupancy", bits, device=dev)
    err = library().bjxa_loadstore_bound(
        prof.data_ptr(), words.data_ptr(), state.data_ptr(), out.data_ptr(),
        end.data_ptr(), scratch.data_ptr(), B, L, bits, ctas, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "bjxa_loadstore_bound")
    LAUNCHES += 1
    return out, end


def null_decode(prof: torch.Tensor, words: torch.Tensor,
                state: torch.Tensor):
    """Touch every input byte and write every output element of the words
    decode, with one add per store.

    Args:
      prof:  ``uint8[B, L]``; words: ``int32[B, bits, L]``;
      state: ``int32[L, 2]``.

    Returns ``(out int16[B, 32, L], end int32[L, 2])``.  Routes by the
    tensors' device alone: a CPU tensor takes :func:`null_decode_plain`, a
    CUDA tensor launches the kernel, anything else raises.
    """
    if words.device.type == "cpu":
        return null_decode_plain(prof, words, state)
    if words.device.type != "cuda":
        raise ValueError(f"null_decode: no kernel for device {words.device}")
    return _launch(prof, words, state)


def words_inputs(seed: int, blocks: int, lanes: int, bits: int,
                 device: torch.device):
    """Seeded words-layout inputs made on ``device``: valid profiles, full
    range payload words, zero states."""
    g = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(-(2**31), 2**31, (blocks, bits, lanes),
                          generator=g, device=device).to(torch.int32)
    factor = torch.randint(0, 5, (blocks, lanes), generator=g, device=device)
    shift = torch.randint(0, 16, (blocks, lanes), generator=g, device=device)
    prof = (factor << 4 | shift).to(torch.uint8)
    state = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
    return prof, words, state


def words_traffic(blocks: int, lanes: int, bits: int) -> int:
    """Bytes the words decode must move at this shape: every input read
    once (profiles, words, states) and every output written once."""
    read = blocks * lanes * (4 * bits + 1) + lanes * 8
    written = blocks * BLOCK_SAMPLES * lanes * 2 + lanes * 8
    return read + written


def measure(bits: int, lanes: int, blocks: int, reps: int,
            device: torch.device) -> dict:
    """Time the load/store kernel and the words decode kernel on the same
    inputs; the record of one bit depth."""
    from bjxa_tpu_torch.ops.cuda_decode_words import fused_decode_words

    prof, words, state = words_inputs(5, blocks, lanes, bits, device)
    bound_ms = time_ms(lambda: null_decode(prof, words, state), device,
                       reps=reps)
    decode_ms = time_ms(
        lambda: fused_decode_words(prof, words, state, bits=bits), device,
        reps=reps,
    )
    samples = lanes * blocks * BLOCK_SAMPLES
    moved = words_traffic(blocks, lanes, bits)
    return {
        "metric": "loadstore_bound",
        "value": round(samples / bound_ms / 1e3, 1),
        "unit": "Msamples/s",
        "gb_per_s": round(moved / bound_ms / 1e6, 1),
        "bound_ms": round(bound_ms, 6),
        "decode_words_ms": round(decode_ms, 6),
        "decode_words_share_of_bound": round(bound_ms / decode_ms, 4),
        "bits": bits,
        "lanes": lanes,
        "blocks": blocks,
        "launches": LAUNCHES,
    }


def main() -> list[dict]:
    device = bench_device()
    env_bits = os.environ.get("BENCH_BITS", "")
    all_bits = (int(env_bits),) if env_bits else (4, 6, 8)
    lanes = env_int("BENCH_FILES", 16384) * 2
    blocks = env_int("BENCH_BLOCKS", 64)
    reps = env_int("BENCH_REPS", 10)
    return [emit(measure(bits, lanes, blocks, reps, device), device)
            for bits in all_bits]


if __name__ == "__main__":
    main()
