"""The two-tap ADPCM prediction filter over lanes, as plain PyTorch.

Port of :mod:`bjxa_tpu.ops.filter`.  The recurrence (reference:
``bjxa_decode_inflated``, ``src/libbjxa.c:533-578``)

    sample[n] = clamp_i16(ranged[n] + trunc(prev0*k0 + prev1*k1, /256))
    prev1, prev0 = prev0, sample[n]

is non-associative (int16 saturation + truncating division), so it runs in
sample order, simultaneously over a *lane* axis of independent channel
streams (channels of one file, or chunks of one stream for the fixed-point
decoder in :mod:`bjxa_tpu_torch.ops.decode`).  The ``lax.scan`` of the JAX
package becomes a Python loop over blocks and their 32 samples: each step
is a handful of elementwise tensor ops over ``[lanes]``.  This is the plain
version every kernel is held against, not the fast path.

C integer semantics reproduced exactly:

* ``gain / 256`` truncates toward zero -> ``(g + ((g >> 31) & 255)) >> 8``
  (torch's ``//`` floors, so it is never used here)
* ``value >> range`` is an arithmetic shift of the int16 value
* clamp saturates to [-32768, 32767] before state update
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
    NUM_FACTORS,
)


def trunc_div_256(g: torch.Tensor) -> torch.Tensor:
    """C-style ``g / 256`` (truncation toward zero) on int32 tensors."""
    return (g + ((g >> 31) & 255)) >> 8


def profile_gains(profiles: torch.Tensor):
    """Decode profile bytes into (k0, k1, shift, valid).

    ``profiles``: int32 ``[...]``.  Table lookups clamp the factor to the
    last entry so invalid factors (>= 5) still produce defined (garbage)
    output; ``valid`` lets the host raise the EPROTO-equivalent, mirroring
    ``src/libbjxa.c:550``.
    """
    factor = (profiles >> 4) & 0x0F
    shift = profiles & 0x0F
    valid = factor < NUM_FACTORS
    idx = torch.clamp(factor, max=NUM_FACTORS - 1).long()
    k0 = torch.as_tensor(GAIN_K0, device=profiles.device)[idx]
    k1 = torch.as_tensor(GAIN_K1, device=profiles.device)[idx]
    return k0, k1, shift, valid


def adpcm_filter_lanes(
    ranged: torch.Tensor,
    k0: torch.Tensor,
    k1: torch.Tensor,
    state: torch.Tensor,
    with_output: bool = True,
):
    """Run the prediction filter over every lane simultaneously.

    Args:
      ranged: ``int32[B, 32, L]`` — unpacked samples already shifted by the
        block range (i.e. the ``ranged`` operand of the recurrence).
      k0, k1: ``int32[B, L]`` — per-block gain coefficients per lane.
      state:  ``int32[L, 2]`` — (prev0, prev1) predictor state per lane.
      with_output: when False only the end state is computed (the
        state-propagation passes of the parallel decoder).

    Returns:
      ``(pcm int16[B, 32, L] | None, end_state int32[L, 2])``
    """
    B = ranged.shape[0]
    c0 = state[:, 0].to(torch.int32)
    c1 = state[:, 1].to(torch.int32)
    pcm = (
        torch.empty(ranged.shape, dtype=torch.int16, device=ranged.device)
        if with_output
        else None
    )
    for b in range(B):
        k0_b, k1_b, r_blk = k0[b], k1[b], ranged[b]
        for n in range(BLOCK_SAMPLES):
            s = r_blk[n] + trunc_div_256(c0 * k0_b + c1 * k1_b)
            s = torch.clamp(s, INT16_MIN, INT16_MAX)
            if with_output:
                pcm[b, n] = s
            c1 = c0
            c0 = s
    return pcm, torch.stack([c0, c1], dim=-1)


def decode_lanes(
    profiles: torch.Tensor,
    samples: torch.Tensor,
    state: torch.Tensor,
    with_output: bool = True,
):
    """Full per-lane block decode: profile decode, range shift, filter.

    Args:
      profiles: ``int32[B, L]`` — profile byte per block per lane.
      samples:  ``int16[B, 32, L]`` — unpacked top-bits sample values.
      state:    ``int32[L, 2]``.

    The route follows the tensors' device alone: CUDA tensors run the
    filter kernel, CPU tensors its plain version
    (:func:`bjxa_tpu_torch.ops.cuda_filter.decode_lanes_kernel` routes).
    There is no fallback between the two.

    Returns ``(pcm int16[B, 32, L] | None, end_state int32[L, 2],
    valid bool[B, L])``.
    """
    from bjxa_tpu_torch.ops.cuda_filter import decode_lanes_kernel

    return decode_lanes_kernel(
        profiles, samples, state, with_output=with_output
    )
