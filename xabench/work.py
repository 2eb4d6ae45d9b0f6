"""The yardstick of the kernel rooflines: the work a window's inputs need,
and the card's peaks.

The counts are algorithmic and fixed here, whatever kernels do the work:
each XA payload byte read once and each PCM byte written once (the reverse
for encode), or the integer operations the arithmetic needs.  Headers are
host work and count for nothing.  The least time is the larger of bytes
over the memory rate and operations over the integer rate.
"""

from __future__ import annotations

#: NVIDIA H100 SXM's published HBM3 rate (data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: Integer instructions a second: half the published 67 TFLOP/s float32
#: rate, which counts a fused multiply-add as two, so one instruction a lane
#: a clock, which no mix of integer instructions exceeds.
INT_OPS_PER_S = 67e12 / 2
#: Integer operations of the decode, a sample: unpack 2 (shift, mask), sign
#: extension 1, range shift 1, a multiply and a multiply-add 2, the
#: truncating divide 4, the sum 1, the clamp 2.
DECODE_OPS_PER_SAMPLE = 13
#: Integer operations of the search, a candidate and sample (its two float
#: operations left out, which keeps the bound a lower one).
ENCODE_OPS_PER_CANDIDATE_SAMPLE = 15
#: Candidates one search tries on every block: 5 factors x 16 ranges.
CANDIDATES = 80
BLOCK_SAMPLES = 32


def decode_work(specs) -> tuple[int, int]:
    """``(bytes, operations)`` of decoding the files ``specs``: the XA
    payload read, the PCM written, 13 operations for every sample of every
    block."""
    nbytes = sum(s.xa_bytes + s.pcm_bytes for s in specs)
    ops = sum(s.blocks * BLOCK_SAMPLES * s.channels for s in specs)
    return nbytes, ops * DECODE_OPS_PER_SAMPLE


def encode_work(specs) -> tuple[int, int]:
    """``(bytes, operations)`` of one search of every block of ``specs``:
    the PCM read, the XA payload written, 80 candidates on every sample;
    no fixed-point round counts."""
    nbytes = sum(s.xa_bytes + s.pcm_bytes for s in specs)
    ops = sum(s.blocks * BLOCK_SAMPLES * s.channels for s in specs)
    return nbytes, ops * CANDIDATES * ENCODE_OPS_PER_CANDIDATE_SAMPLE


def least_time(nbytes: int, ops: int) -> tuple[float, str]:
    """The least seconds the card could take, and which bound sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
