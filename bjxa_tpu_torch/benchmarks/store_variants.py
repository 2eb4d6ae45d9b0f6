"""Micro-bench: store-side variants of the fused 8-bit decode kernel.

Port of ``benchmarks/bench_store_variants.py``.  The ablation
(:mod:`~bjxa_tpu_torch.benchmarks.ablate`) says what the PCM stores cost as
a whole; this measures store forms to find where that cost sits:

  i16  : int16 per-sample store (the production kernel)
  i32  : int32 per-sample store (no narrowing; twice the bytes written)
  pair : two consecutive samples packed into one int32 word
         (``(s0 & 0xFFFF) | (s1 << 16)``); half the stores, the
         bytes of ``i16``; output ``int32[B, 16, L]`` whose little-endian
         int16 view is the natural ``[B, 32, L]`` sample order per lane.

The kernel, ``csrc/decode_variants.cu`` (its ``u8`` instantiations: one byte
a sample from ``uint8[B, 33, L]``, each warp's 32 bytes of a row staged
through the words kernel's ``cp.async`` ring), replaces
``bench_store_variants._kernel``.  It runs the words kernel's chunk
schedule at its K (:func:`decode_variant_chunked` forces K and returns the
rounds).  Every variant is checked bit-exact against the production lanes
kernel before it is timed.

    python -m bjxa_tpu_torch.benchmarks.store_variants

Env: ``BENCH_LANES`` (32,768), ``BENCH_BLOCKS`` (64), ``BENCH_REPS``; a
corpus batch, the shape corpus runs launch, is ``BENCH_LANES=32
BENCH_BLOCKS=20736``.  One
JSON line per variant, in Gsamples/s.
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
from bjxa_tpu_torch.ops.cuda_decode import (
    chunked_lanes_plain,
    fused_decode_lanes,
    fused_decode_lanes_plain,
)
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

#: Launches of the u8 variants in this process (plain runs never count).
LAUNCHES = 0
MODES = ("i16", "i32", "pair")


def decode_variant_plain(blocks_t: torch.Tensor, state: torch.Tensor, *,
                         mode: str):
    """Plain PyTorch version of the ``u8`` variants: the lanes kernel's
    plain version, then the repack into the store form.  Same arguments and
    returns as :func:`decode_variant`, on any device."""
    pcm, end = fused_decode_lanes_plain(blocks_t, state, bits=_variants.BITS)
    return _variants.repack(pcm, mode), end


def decode_variant_chunked_plain(blocks_t: torch.Tensor,
                                 state: torch.Tensor, *, mode: str,
                                 chunks: int):
    """Plain PyTorch version of the kernel's schedule at ``chunks``:
    :func:`~bjxa_tpu_torch.ops.cuda_decode.chunked_lanes_plain` (the words
    kernel's schedule over lane-major blocks), then the repack into the
    store form.  On any device.

    Returns ``(out, end int32[L, 2], rounds)``, ``rounds`` an int."""
    pcm, end, rounds = chunked_lanes_plain(blocks_t, state,
                                           bits=_variants.BITS, chunks=chunks)
    return _variants.repack(pcm, mode), end, rounds


def decode_variant_chunked(blocks_t: torch.Tensor, state: torch.Tensor, *,
                           mode: str, chunks: int | None = None):
    """Launch a ``u8`` variant on CUDA tensors (one cooperative launch, no
    host sync) at the words kernel's K, or at ``chunks`` where given.

    Returns ``(out, end int32[L, 2], rounds int32[1])``, ``rounds`` left on
    the card.  A non-CUDA tensor, a refused launch or a failed build
    raises; nothing falls back.
    """
    global LAUNCHES
    if blocks_t.device.type != "cuda":
        raise ValueError(
            f"decode_variant: no kernel for device {blocks_t.device}"
        )
    out = _variants.launch_variant("decode_variant", "u8", mode, blocks_t,
                                   None, state, chunks=chunks)
    LAUNCHES += 1
    return out


def decode_variant(blocks_t: torch.Tensor, state: torch.Tensor, *,
                   mode: str):
    """Decode 8-bit lane-major raw blocks, storing in form ``mode``.

    Args:
      blocks_t: ``uint8[B, 33, L]``; state: ``int32[L, 2]``;
      mode: ``"i16"``, ``"i32"`` or ``"pair"``.

    Returns ``(out, end int32[L, 2])`` with ``out`` ``int16[B, 32, L]``,
    ``int32[B, 32, L]`` or ``int32[B, 16, L]``.  Routes by the tensors'
    device alone: a CPU tensor takes :func:`decode_variant_plain`, a CUDA
    tensor launches the kernel (:func:`decode_variant_chunked`), anything
    else raises.
    """
    if blocks_t.device.type == "cpu":
        return decode_variant_plain(blocks_t, state, mode=mode)
    out, end, _rounds = decode_variant_chunked(blocks_t, state, mode=mode)
    return out, end


def check_variants(blocks_t, state) -> None:
    """Every u8 variant equals the production lanes kernel on these
    inputs; the pair form through its int16 view."""
    ref_pcm, ref_end = fused_decode_lanes(blocks_t, state,
                                          bits=_variants.BITS)
    outs = {m: decode_variant(blocks_t, state, mode=m) for m in MODES}
    for name, a, b in (
        ("u8+i16 vs lanes kernel", outs["i16"][0], ref_pcm),
        ("u8+i32 narrowed", outs["i32"][0], ref_pcm.to(torch.int32)),
        ("u8+pair int16 view", _variants.pair_to_i16(outs["pair"][0]),
         ref_pcm),
        *((f"u8+{m} end", outs[m][1], ref_end) for m in MODES),
    ):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"store variants: {name} differs")


def main() -> list[dict]:
    device = bench_device()
    lanes = env_int("BENCH_LANES", 32768)
    blocks = env_int("BENCH_BLOCKS", 64)
    reps = env_int("BENCH_REPS", 10)
    blocks_t = random_lanes(7, blocks, lanes, _variants.BITS, device)
    state = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
    check_variants(blocks_t, state)

    samples = lanes * blocks * BLOCK_SAMPLES
    out = []
    for mode in MODES:
        ms = time_ms(lambda: decode_variant(blocks_t, state, mode=mode),
                     device, reps=reps)
        out.append(emit({
            "metric": "store_variant_rate", "variant": f"u8+{mode}",
            "value": round(samples / ms / 1e6, 3), "unit": "Gsamples/s",
            "ms": round(ms, 6), "bit_exact": True, "lanes": lanes,
            "blocks": blocks, "launches": LAUNCHES,
        }, device))
    return out


if __name__ == "__main__":
    main()
