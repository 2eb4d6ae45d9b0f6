"""Vectorized XA bit-unpack ("inflate") as plain PyTorch tensor code.

Port of :mod:`bjxa_tpu.ops.inflate`: the reference's per-block unpack
callbacks (``src/libbjxa.c:286-345``) become whole-array integer ops over
``[..., blocks, block_size]`` tensors, specialized on the bit depth.

Packed samples land in the *top* ``bits`` bits of an int16 (the format
produces negative values by design); the arithmetic stays in int32 with the
low 16 bits holding the sign-extended int16 value.  Bytes are widened to
int32 before any shift: ``uint8 << 8`` would wrap inside uint8.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES


def sign_extend_16(x: torch.Tensor) -> torch.Tensor:
    """Sign-extend the low 16 bits of an int32 tensor in place of int16."""
    x = x.to(torch.int32)
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def unpack_payload(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Unpack packed sample bytes to int32 "top-bits" sample values.

    ``payload``: ``uint8[..., bits*4]``.  Returns ``int32[..., 32]``.
    The bit layouts mirror the format spec exactly (4-bit: two nibbles per
    byte; 6-bit: 3 bytes -> 4 samples through a 24-bit window; 8-bit: one
    byte shifted high).
    """
    b = payload.to(torch.int32)
    lead = b.shape[:-1]
    if bits == 4:
        hi = (b & 0xF0) << 8
        lo = (b & 0x0F) << 12
        out = torch.stack([hi, lo], dim=-1).reshape(*lead, BLOCK_SAMPLES)
    elif bits == 6:
        trip = b.reshape(*lead, 8, 3)
        w = (trip[..., 0] << 16) | (trip[..., 1] << 8) | trip[..., 2]
        out = torch.stack(
            [
                (w & 0x00FC0000) >> 8,
                (w & 0x0003F000) >> 2,
                (w & 0x00000FC0) << 4,
                (w & 0x0000003F) << 10,
            ],
            dim=-1,
        ).reshape(*lead, BLOCK_SAMPLES)
    elif bits == 8:
        out = b << 8
    else:
        raise ValueError(f"unpack_payload: bad bit depth {bits}")
    return sign_extend_16(out)


def unpack_payload_lanes(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """Lane-major twin of :func:`unpack_payload`.

    ``payload``: ``uint8[B, bits*4, L]`` — packed sample bytes with the lane
    axis minor (the layout the decode kernel reads).  Returns
    ``int16[B, 32, L]``.
    """
    b = payload.to(torch.int32)
    B, _nbytes, L = b.shape
    if bits == 4:
        hi = (b & 0xF0) << 8  # [B, 16, L] -> samples 0, 2, 4, ...
        lo = (b & 0x0F) << 12  # -> samples 1, 3, 5, ...
        out = torch.stack([hi, lo], dim=2).reshape(B, BLOCK_SAMPLES, L)
    elif bits == 6:
        t0 = b[:, 0::3]  # [B, 8, L] first byte of each 3-byte triple
        t1 = b[:, 1::3]
        t2 = b[:, 2::3]
        s0 = (t0 & 0xFC) << 8
        s1 = ((t0 & 0x03) << 14) | ((t1 & 0xF0) << 6)
        s2 = ((t1 & 0x0F) << 12) | ((t2 & 0xC0) << 4)
        s3 = (t2 & 0x3F) << 10
        out = torch.stack([s0, s1, s2, s3], dim=2).reshape(
            B, BLOCK_SAMPLES, L
        )
    elif bits == 8:
        out = b << 8
    else:
        raise ValueError(f"unpack_payload_lanes: bad bit depth {bits}")
    return sign_extend_16(out).to(torch.int16)


def inflate_lanes(blocks_t: torch.Tensor, bits: int):
    """Lane-major twin of :func:`inflate_blocks`.

    ``blocks_t``: ``uint8[B, block_size, L]`` raw blocks, lane-minor.
    Returns ``(profile int32[B, L], samples int16[B, 32, L])``.
    """
    profiles = blocks_t[:, 0, :].to(torch.int32)
    samples = unpack_payload_lanes(blocks_t[:, 1:, :], bits)
    return profiles, samples


def inflate_blocks(blocks: torch.Tensor, bits: int):
    """Split raw XA blocks into profiles and unpacked sample values.

    ``blocks``: ``uint8[..., block_size]`` with the leading profile byte.
    Returns ``(profile int32[...], samples int16[..., 32])``.
    """
    profiles = blocks[..., 0].to(torch.int32)
    samples = unpack_payload(blocks[..., 1:], bits).to(torch.int16)
    return profiles, samples
