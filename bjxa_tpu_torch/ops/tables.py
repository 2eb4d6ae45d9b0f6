"""Codec constants shared by every compute path.

The two-tap prediction gain table comes from the XA format specification
(reference: ``bjxa.5.rst:110-129``; fixed-point x256 table at
``src/libbjxa.c:525-531``).  A profile byte packs ``factor`` (high nibble,
must be < 5) and ``range`` (low nibble) per 32-sample block.
"""

from __future__ import annotations

import numpy as np

BLOCK_SAMPLES = 32
NUM_FACTORS = 5
NUM_RANGES = 16

# Fixed-point (x256) two-tap predictor gains, indexed by profile factor.
GAIN_K0 = np.array([0, 240, 460, 392, 488], dtype=np.int32)
GAIN_K1 = np.array([0, 0, -208, -220, -240], dtype=np.int32)

INT16_MIN = -32768
INT16_MAX = 32767


def block_size_for_bits(bits: int) -> int:
    """Bytes per single-channel XA block: 1 profile byte + 32 packed samples."""
    return bits * 4 + 1
