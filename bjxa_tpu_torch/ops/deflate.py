"""XA bit-pack ("deflate") as plain PyTorch, on any device.

Port of :mod:`bjxa_tpu.ops.deflate`, the inverse of
:mod:`bjxa_tpu_torch.ops.inflate` and the equivalent of the reference's pack
callbacks (``src/libbjxa.c:349-391``).  Keeps the top ``bits`` bits of each
16-bit sample value and packs them densely.  The JAX package computes this
outside any Pallas kernel, so it has no kernel here either: a handful of
elementwise ops over the whole stream.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES


def pack_payload(samples: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int16-domain "top-bits" samples into payload bytes.

    ``samples``: int-like ``[..., 32]`` (low 16 bits significant).
    Returns ``uint8[..., bits*4]`` on the same device.
    """
    u = samples.to(torch.int32) & 0xFFFF  # value as uint16
    lead = u.shape[:-1]
    if bits == 4:
        pair = u.reshape(*lead, BLOCK_SAMPLES // 2, 2)
        by = ((pair[..., 0] >> 8) & 0xF0) | (pair[..., 1] >> 12)
    elif bits == 6:
        quad = (u >> 10).reshape(*lead, BLOCK_SAMPLES // 4, 4)
        w = (
            (quad[..., 0] << 18)
            | (quad[..., 1] << 12)
            | (quad[..., 2] << 6)
            | quad[..., 3]
        )
        by = torch.stack(
            [w >> 16, (w >> 8) & 0xFF, w & 0xFF], dim=-1
        ).reshape(*lead, 24)
    elif bits == 8:
        by = u >> 8
    else:
        raise ValueError(f"pack_payload: bad bit depth {bits}")
    return by.to(torch.uint8)


def deflate_blocks(
    profiles: torch.Tensor, samples: torch.Tensor, bits: int
) -> torch.Tensor:
    """Assemble raw XA blocks: profile byte + packed payload.

    ``profiles``: int-like ``[...]``; ``samples``: ``[..., 32]``.
    Returns ``uint8[..., block_size]``.
    """
    payload = pack_payload(samples, bits)
    prof = profiles.to(torch.uint8)[..., None]
    return torch.cat([prof, payload], dim=-1)
