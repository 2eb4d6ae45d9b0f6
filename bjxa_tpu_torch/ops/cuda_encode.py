"""Exhaustive profile-search encode over lanes: the CUDA kernel and its
plain twin.

Port of :mod:`bjxa_tpu.ops.pallas_encode`.  The kernel,
``csrc/encode_search.cu``, replaces ``pallas_encode._encode_kernel``: per
block, each of the 80 candidate profiles (``factor*16 + range``) runs the
real decoder recurrence over the 32 samples, the squared reconstruction
error accumulates in float32 in sample order, the first strict minimum
wins, and the winner is re-run to emit the coded values, the exact
reconstruction and the carried predictor state.  It is bound by integer
issue (~15 integer and 2 float ops per candidate-sample, 2,560
candidate-samples per block).

Design (see the source): one CTA of 16 warps owns 32 lanes; warp ``w``
searches range ``w`` over the 5 factors for all 32 lanes, and the lane's
winner is the lexicographic minimum of ``(err, profile)`` over the 16
per-range winners, which is the plain version's first minimum
(``torch.argmin`` over candidates in profile order).  The winners' full
re-runs, which write ``coded`` and ``recon``, run after the block loop,
in parallel over blocks.

:func:`encode_search_lanes` routes by the tensors' device alone: a CPU
tensor takes :func:`encode_search_lanes_plain`, a CUDA tensor launches the
kernel, anything else raises.  No lane or block padding is needed: the
kernel masks the lanes of its last CTA and loops over every block.
"""

from __future__ import annotations

import torch

from bjxa_tpu_torch.ops.encode import NUM_CANDIDATES, _candidate_tables
from bjxa_tpu_torch.ops.filter import trunc_div_256
from bjxa_tpu_torch.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
)

#: Launches of the encode kernel in this process (plain runs never count).
LAUNCHES = 0


def encode_search_lanes_plain(
    pcm: torch.Tensor, state: torch.Tensor, *, bits: int
):
    """Plain PyTorch version of the search kernel, on any device.

    A port of :func:`bjxa_tpu.ops.encode.encode_search_scan`: the
    ``lax.scan`` over blocks becomes a Python loop over blocks and their 32
    samples on ``[80, L]`` tensors.  ``torch.argmin`` returns the first
    minimum, and the error is summed as ``err + e * e`` in two float32
    ops (no fused multiply-add), so the choice matches every other
    implementation bit for bit.  Same arguments and returns as
    :func:`encode_search_lanes`; it never launches a kernel.
    """
    B, _, L = pcm.shape
    dev = pcm.device
    shq = 16 - bits
    factor_np, range_np = _candidate_tables()

    def col(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)[:, None]

    k0 = col(GAIN_K0[factor_np])  # [80, 1]
    k1 = col(GAIN_K1[factor_np])
    rr = col(range_np)
    s_down = torch.clamp(shq - rr, min=0)  # quantize: arithmetic shift down
    s_up = torch.clamp(rr - shq, min=0)  # or scale up when range > headroom
    bias = (torch.ones_like(s_down) << s_down) >> 1
    use_down = rr <= shq
    qmin = -(1 << (bits - 1))
    qmax = (1 << (bits - 1)) - 1
    prof_cand = torch.as_tensor(
        (factor_np << 4) | range_np, dtype=torch.int32, device=dev
    )

    x_all = pcm.to(torch.int32)
    p0 = state[:, 0].to(torch.int32)
    p1 = state[:, 1].to(torch.int32)
    profiles = torch.empty((B, L), dtype=torch.int32, device=dev)
    coded = torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev)
    recon = torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev)
    for b in range(B):
        a0 = p0.expand(NUM_CANDIDATES, L)
        a1 = p1.expand(NUM_CANDIDATES, L)
        err = torch.zeros((NUM_CANDIDATES, L), dtype=torch.float32, device=dev)
        ds = []
        recs = []
        for n in range(BLOCK_SAMPLES):
            x = x_all[b, n][None, :]
            pred = trunc_div_256(a0 * k0 + a1 * k1)
            diff = x - pred
            q = torch.where(use_down, (diff + bias) >> s_down, diff << s_up)
            q = torch.clamp(q, qmin, qmax)
            d = q << shq
            rec = torch.clamp((d >> rr) + pred, INT16_MIN, INT16_MAX)
            e = (x - rec).to(torch.float32)
            err = err + e * e
            ds.append(d)
            recs.append(rec)
            a1 = a0
            a0 = rec
        best = torch.argmin(err, dim=0)[None, :]  # [1, L], first minimum
        profiles[b] = prof_cand[best[0]]
        for n in range(BLOCK_SAMPLES):
            coded[b, n] = ds[n].gather(0, best)[0]
            recon[b, n] = recs[n].gather(0, best)[0]
        p0 = a0.gather(0, best)[0]
        p1 = a1.gather(0, best)[0]
    return profiles, coded, recon, torch.stack([p0, p1], dim=-1)


def _launch(pcm, state, *, bits):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    if bits not in (4, 6, 8):
        raise ValueError(f"encode_search_lanes: bad bit depth {bits}")
    if pcm.dim() != 3 or pcm.shape[1] != BLOCK_SAMPLES:
        raise ValueError(f"encode_search_lanes: pcm {tuple(pcm.shape)} is not"
                         f" [B, {BLOCK_SAMPLES}, L]")
    B, _, L = pcm.shape
    if pcm.dtype != torch.int16 or state.dtype != torch.int32:
        raise TypeError(
            "encode_search_lanes: want int16 pcm and int32 state, got"
            f" {pcm.dtype} and {state.dtype}"
        )
    if tuple(state.shape) != (L, 2):
        raise ValueError(f"encode_search_lanes: state {tuple(state.shape)}"
                         f" != ({L}, 2)")
    if state.device != pcm.device:
        raise ValueError("encode_search_lanes: pcm and state on"
                         f" {pcm.device} and {state.device}")
    if not (pcm.is_contiguous() and state.is_contiguous()):
        raise ValueError("encode_search_lanes: inputs must be contiguous")
    dev = pcm.device
    profiles = torch.empty((B, L), dtype=torch.int32, device=dev)
    coded = torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev)
    recon = torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev)
    end = torch.empty((L, 2), dtype=torch.int32, device=dev)
    if L == 0:
        return profiles, coded, recon, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().bjxa_encode_search(
        pcm.data_ptr(), state.data_ptr(), profiles.data_ptr(),
        coded.data_ptr(), recon.data_ptr(), end.data_ptr(),
        B, L, bits, dev.index, stream,
    )
    check_launch(err, "bjxa_encode_search")
    LAUNCHES += 1
    return profiles, coded, recon, end


def encode_search_lanes(pcm: torch.Tensor, state: torch.Tensor, *, bits: int):
    """Greedy exhaustive profile-search encode over lanes.

    Args:
      pcm:   ``int16[B, 32, L]`` target samples, lane-minor (zero-padded
        final block).
      state: ``int32[L, 2]`` entry predictor state per lane.

    Returns ``(profiles int32[B, L], coded int16[B, 32, L],
    recon int16[B, 32, L], end_state int32[L, 2])`` — the contract of
    :func:`bjxa_tpu.ops.pallas_encode.encode_search_pallas_core`.
    ``recon`` is the exact signal a conforming decoder will produce.
    """
    if pcm.device.type == "cpu":
        return encode_search_lanes_plain(pcm, state, bits=bits)
    if pcm.device.type != "cuda":
        raise ValueError(
            f"encode_search_lanes: no kernel for device {pcm.device}"
        )
    return _launch(pcm, state, bits=bits)
