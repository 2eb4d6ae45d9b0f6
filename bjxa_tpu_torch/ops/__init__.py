"""Device compute path: inflate, the filter recurrence, the CUDA kernels
and their plain twins, the whole-file decode pipelines and the batch
decode and encode of many streams."""

from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES, GAIN_K0, GAIN_K1
from bjxa_tpu_torch.ops.decode import (
    decode_arrays,
    decode_arrays_fixpoint,
    decode_batch,
    decode_bytes,
    blocks_from_bytes,
    decode_batch_lanes,
    decode_batch_words,
    decode_batch_packed,
    packed_layout,
    pack_words_from_lanes,
    words_from_blocks_host,
    words_to_blocks,
)
from bjxa_tpu_torch.ops.encode import encode_batch_blocks

__all__ = [
    "BLOCK_SAMPLES",
    "GAIN_K0",
    "GAIN_K1",
    "decode_arrays",
    "decode_arrays_fixpoint",
    "decode_batch",
    "decode_bytes",
    "blocks_from_bytes",
    "decode_batch_lanes",
    "decode_batch_words",
    "decode_batch_packed",
    "packed_layout",
    "pack_words_from_lanes",
    "words_from_blocks_host",
    "words_to_blocks",
    "encode_batch_blocks",
]
