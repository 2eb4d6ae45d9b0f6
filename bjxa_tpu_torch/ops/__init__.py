"""Device compute path: inflate, the filter recurrence, the CUDA kernels
and their plain twins, and the whole-file decode pipelines."""

from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES, GAIN_K0, GAIN_K1
from bjxa_tpu_torch.ops.decode import (
    decode_arrays,
    decode_bytes,
    blocks_from_bytes,
)

__all__ = [
    "BLOCK_SAMPLES",
    "GAIN_K0",
    "GAIN_K1",
    "decode_arrays",
    "decode_bytes",
    "blocks_from_bytes",
]
