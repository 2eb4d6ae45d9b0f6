"""Ablation micro-bench: which side of the fused decode kernel binds?

Port of ``benchmarks/bench_ablate.py``.  Times the full lanes kernel (loads
+ filter + int16 stores) against its states-only instantiation (the same
loads and filter, no PCM stores) at the headline bench shape.  If
states-only is much faster, the stores bind; if it matches, the loads do.

    python -m bjxa_tpu_torch.benchmarks.ablate

Env: ``BENCH_BITS`` (8), ``BENCH_LANES`` (32,768), ``BENCH_BLOCKS`` (64),
``BENCH_REPS``.  One JSON line per instantiation, in Gsamples/s.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.benchmarks._common import (
    bench_device,
    emit,
    env_int,
    random_lanes,
    time_ms,
)
from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES


def main() -> list[dict]:
    device = bench_device()
    bits = env_int("BENCH_BITS", 8)
    lanes = env_int("BENCH_LANES", 32768)
    blocks = env_int("BENCH_BLOCKS", 64)
    reps = env_int("BENCH_REPS", 10)
    blocks_t = random_lanes(7, blocks, lanes, bits, device)
    state = torch.zeros((lanes, 2), dtype=torch.int32, device=device)
    samples = lanes * blocks * BLOCK_SAMPLES
    out = []
    for label, with_output in (("full", True), ("states-only", False)):
        ms = time_ms(
            lambda: fused_decode_lanes(blocks_t, state, bits=bits,
                                       with_output=with_output),
            device, reps=reps,
        )
        out.append(emit({
            "metric": "decode_ablation_rate", "variant": label,
            "value": round(samples / ms / 1e6, 3), "unit": "Gsamples/s",
            "ms": round(ms, 6), "bits": bits, "lanes": lanes,
            "blocks": blocks,
        }, device))
    return out


if __name__ == "__main__":
    main()
