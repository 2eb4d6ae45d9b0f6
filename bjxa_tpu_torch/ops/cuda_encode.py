"""Exhaustive profile-search encode over lanes: the CUDA kernels and their
plain twins.

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

One CTA walks every block of its 32 lanes, so a stream of few lanes runs on
one SM.  :func:`encode_search_fixpoint_lanes` gives such a stream the SMs:
``csrc/encode_fixpoint.cu`` cuts each lane into K chunks and solves their
entry states by the exact fixed point inside ONE cooperative launch (a CTA
a tile of :data:`TILE_ITEMS` chunk items, the same per-block search; each
round after the first searches only the items whose start moved), reading
and writing the stream in place.  Its plain twin,
:func:`encode_search_fixpoint_lanes_plain`, is the host loop
:func:`bjxa_tpu_torch.ops.encode.encode_search_fixpoint` over
:func:`encode_search_lanes_plain`; it routes the same way.
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

#: Chunk items a CTA of the fixed-point kernel searches together
#: (``csrc/encode_fixpoint.cu``): 8 warps, two for each of an SM's four
#: schedulers, one running factors 0-2 and one 3-4 of the 16 ranges for the
#: 8 chains.
TILE_ITEMS = 8

#: Launches of the encode kernel in this process (plain runs never count).
LAUNCHES = 0
#: Launches of the fixed-point kernel in this process (plain runs never
#: count).
FIXPOINT_LAUNCHES = 0


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


def _check(pcm, state, bits: int, name: str):
    """Check a search kernel's arguments; returns its empty outputs
    ``(profiles, coded, recon, end)`` on ``pcm``'s device."""
    if bits not in (4, 6, 8):
        raise ValueError(f"{name}: bad bit depth {bits}")
    if pcm.dim() != 3 or pcm.shape[1] != BLOCK_SAMPLES:
        raise ValueError(f"{name}: pcm {tuple(pcm.shape)} is not"
                         f" [B, {BLOCK_SAMPLES}, L]")
    B, _, L = pcm.shape
    if pcm.dtype != torch.int16 or state.dtype != torch.int32:
        raise TypeError(
            f"{name}: want int16 pcm and int32 state, got"
            f" {pcm.dtype} and {state.dtype}"
        )
    if tuple(state.shape) != (L, 2):
        raise ValueError(f"{name}: state {tuple(state.shape)} != ({L}, 2)")
    if state.device != pcm.device:
        raise ValueError(f"{name}: pcm and state on"
                         f" {pcm.device} and {state.device}")
    if not (pcm.is_contiguous() and state.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    dev = pcm.device
    return (torch.empty((B, L), dtype=torch.int32, device=dev),
            torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev),
            torch.empty((B, BLOCK_SAMPLES, L), dtype=torch.int16, device=dev),
            torch.empty((L, 2), dtype=torch.int32, device=dev))


def _launch(pcm, state, *, bits):
    global LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library

    profiles, coded, recon, end = _check(pcm, state, bits,
                                         "encode_search_lanes")
    B, _, L = pcm.shape
    dev = pcm.device
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


# --------------------------------------------------------------------------
# the chunk fixed point in one cooperative launch
# --------------------------------------------------------------------------


class FixpointOut(tuple):
    """What :func:`encode_search_fixpoint_lanes` returns: ``(profiles,
    coded, recon, end, rounds)``, and ``searched``, the chunk items its
    states-only rounds searched, as the host loop counts them (``K x L`` in
    its first round, then those whose start changed in the round before;
    ``L`` when K = 1, 0 when B = 0), a one-element int32 tensor beside
    ``rounds``, not synced."""

    def __new__(cls, outputs, searched):
        self = super().__new__(cls, outputs)
        self.searched = searched
        return self


def fixpoint_chunks(B: int, num_chunks: int) -> tuple[int, int]:
    """``(K, Bc)`` of the fixed point at ``num_chunks`` chunks: the host
    loop's own cut, Bc = ceil(B / K), the stream padded to K*Bc blocks
    (whole chunks of pad included); ``B = 0`` gives ``(1, 0)``."""
    if num_chunks < 1:
        raise ValueError(f"encode_search_fixpoint: {num_chunks} chunks")
    if B == 0:
        return 1, 0
    return num_chunks, -(-B // num_chunks)


def encode_search_fixpoint_lanes_plain(
    pcm: torch.Tensor, state: torch.Tensor, *, bits: int, num_chunks: int
):
    """Plain PyTorch version of the fixed-point kernel: the host loop
    :func:`bjxa_tpu_torch.ops.encode.encode_search_fixpoint` over
    :func:`encode_search_lanes_plain`, its rounds as a one-element int32
    tensor and its searched items counted from the starts of its rounds.
    On any device; it never launches a kernel.  Same arguments and returns
    as :func:`encode_search_fixpoint_lanes`."""
    from bjxa_tpu_torch.ops.encode import encode_search_fixpoint

    _check(pcm, state, bits, "encode_search_fixpoint_lanes")
    K, _ = fixpoint_chunks(pcm.shape[0], num_chunks)
    starts = []  # each round's chunk starts

    def run(lanes, states):
        starts.append(states)
        return encode_search_lanes_plain(lanes, states, bits=bits)

    *out, rounds = encode_search_fixpoint(pcm, state, bits=bits,
                                          num_chunks=num_chunks, run=run)
    searched = 0
    if rounds:
        searched = K * pcm.shape[2] + sum(
            int((a != b).any(dim=-1).sum())
            for a, b in zip(starts, starts[1:]))
    return FixpointOut((*out, _count(rounds, pcm.device)),
                       _count(searched, pcm.device))


def _count(n: int, device) -> torch.Tensor:
    return torch.tensor([n], dtype=torch.int32, device=device)


def _launch_fixpoint(pcm, state, *, bits, num_chunks):
    global FIXPOINT_LAUNCHES
    from bjxa_tpu_torch.ops._build import check_launch, library
    from bjxa_tpu_torch.ops.cuda_decode import occupancy

    profiles, coded, recon, end = _check(pcm, state, bits,
                                         "encode_search_fixpoint_lanes")
    B, _, L = pcm.shape
    K, Bc = fixpoint_chunks(B, num_chunks)
    dev = pcm.device
    items = K * L
    if L == 0:
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        return FixpointOut((profiles, coded, recon, end, counts[:1]),
                           counts[1:])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    tiles = -(-items // TILE_ITEMS)
    fit = occupancy("bjxa_encode_fixpoint_occupancy", bits, index) * sms
    ctas = max(1, min(tiles, fit))
    scratch = torch.empty(6 + K + 8 * items + ctas if K > 1 else 4,
                          dtype=torch.int32, device=dev)
    rounds, searched = scratch[2:3], scratch[3:4]
    err = library().bjxa_encode_fixpoint(
        pcm.data_ptr(), state.data_ptr(), profiles.data_ptr(),
        coded.data_ptr(), recon.data_ptr(), end.data_ptr(),
        scratch.data_ptr(), B, L, K, Bc, bits, ctas, index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "bjxa_encode_fixpoint")
    FIXPOINT_LAUNCHES += 1
    if K == 1 and B > 0:
        # no states-only round runs; the pass with output is the host
        # loop's one round over every lane
        rounds = _count(1, dev)
        searched = _count(L, dev)
    return FixpointOut((profiles, coded, recon, end, rounds), searched)


def encode_search_fixpoint_lanes(
    pcm: torch.Tensor, state: torch.Tensor, *, bits: int, num_chunks: int
):
    """The search of :func:`encode_search_lanes` through the exact chunk
    fixed point of :func:`bjxa_tpu_torch.ops.encode.encode_search_fixpoint`
    at ``num_chunks`` chunks a lane: ONE cooperative launch on a CUDA
    tensor, the host loop on a CPU tensor; anything else raises.

    Args:
      pcm:   ``int16[B, 32, L]`` target samples in stream order, lane-minor
        (zero-padded final block).
      state: ``int32[L, 2]`` entry predictor state per lane.

    Returns a :class:`FixpointOut`: ``(profiles int32[B, L], coded int16[B,
    32, L], recon int16[B, 32, L], end int32[L, 2], rounds int32[1])`` on
    ``pcm``'s device, the sequential search's outputs, bit for bit, the
    state after block B - 1, and the host loop's round count (0 when
    B = 0) without a sync; and the items searched in ``.searched``.
    """
    if pcm.device.type == "cpu":
        return encode_search_fixpoint_lanes_plain(pcm, state, bits=bits,
                                                  num_chunks=num_chunks)
    if pcm.device.type != "cuda":
        raise ValueError(
            f"encode_search_fixpoint_lanes: no kernel for device {pcm.device}"
        )
    return _launch_fixpoint(pcm, state, bits=bits, num_chunks=num_chunks)
