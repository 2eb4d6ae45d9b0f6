"""Device-sharded decode and encode: data parallel over files, sequence
parallel over the block range of a single stream.

Port of :mod:`bjxa_tpu.parallel.sharded`.  JAX runs each function as one
``shard_map`` program over its mesh; here one controller drives the mesh
(:mod:`bjxa_tpu_torch.parallel.mesh`): the host stages each shard's inputs
in the layout its device consumes, copies them to that device, and
launches every shard's work before it waits on any, so shards on distinct
cards run at once.  Every shard runs the single-device op of
:mod:`bjxa_tpu_torch.ops` on its own device: a kernel on a card, its plain
version on the CPU.

The whole cross-device "context" of an XA stream is two int16 predictor
taps per channel (``bjxa.5.rst:186-187``), so sequence-parallel decode is a
boundary-state fixed point over the device ring: every device decodes its
block range from a guessed input state, hands its exact end state to the
next device (``Tensor.to``: a peer copy between cards, the counterpart of
``lax.ppermute``), and the ring iterates until no entry state changed (one
host-side ``any`` a round, the counterpart of the ``psum``) -- at most
``n_devices`` rounds, typically 2-3, each round internally running the
intra-device chunk fixed point.  The result is bit-exact, and so is the
round count.  The intra-device fixed point syncs the host once a local
round, so a shard's rounds block the next shard's launches: shards overlap
only between those syncs.

JAX caches each jitted ``shard_map`` wrapper (``functools.lru_cache``) so a
batch does not re-trace; there is no jit here, so there is nothing to
cache.
"""

from __future__ import annotations

import numpy as np
import torch

from bjxa_tpu_torch.ops.chunking import fixpoint_states
from bjxa_tpu_torch.ops.decode import (
    decode_batch,
    decode_batch_lanes,
    decode_batch_words,
    fixpoint_lanes_core,
    fixpoint_lanes_end_state,
)
from bjxa_tpu_torch.ops.deflate import deflate_blocks
from bjxa_tpu_torch.ops.encode import (
    encode_search,
    encode_search_auto,
    encode_truncate,
)
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES
from bjxa_tpu_torch.parallel.mesh import Mesh, dp_sharding


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A contiguous host copy of ``a`` when it needs one, sent to
    ``device`` without blocking."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device, non_blocking=True)


def _pad_lanes(a: np.ndarray, pad: int, axis: int) -> np.ndarray:
    """``a`` with ``pad`` zero lanes appended along ``axis``."""
    if not pad:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=axis)


def _lane_shards(L: int, n: int) -> tuple[int, list[slice]]:
    """``(pad, slices)``: lanes padded to a multiple of ``n``, then split
    into ``n`` equal contiguous slices."""
    pad = (-L) % n
    w = (L + pad) // n
    return pad, [slice(i * w, (i + 1) * w) for i in range(n)]


def host_flat(shards) -> np.ndarray:
    """The flat per-shard results of :func:`decode_corpus_sharded_words` and
    :func:`encode_corpus_sharded_flat` as ONE host vector, shard-major: the
    input their ``reassemble`` takes."""
    return np.concatenate([s.cpu().numpy() for s in shards])


# --------------------------------------------------------------------------
# data parallel over files
# --------------------------------------------------------------------------


def decode_corpus_sharded(
    blocks, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Decode a batch of equal-shape files sharded over the mesh's file axis.

    Args:
      blocks: ``uint8[N, C, B, block_size]`` with N divisible by the axis
        size (the corpus engine pads with dummy files).
      states: ``int32[N, C, 2]``.

    Each device runs :func:`~bjxa_tpu_torch.ops.decode.decode_batch` on its
    files (the filter kernel on a card); file lanes never communicate.

    Returns host tensors ``(pcm int16[N, B*32, C], end int32[N, C, 2],
    valid bool[B, N, C])``.
    """
    blocks = np.asarray(blocks)
    states = np.asarray(states, np.int32)
    parts = zip(dp_sharding(mesh, blocks.ndim, axis).shard(blocks),
                dp_sharding(mesh, 3, axis).shard(states))
    outs = [decode_batch(b, s, bits=bits) for b, s in parts]
    return (
        torch.cat([o[0].cpu() for o in outs]),
        torch.cat([o[1].cpu() for o in outs]),
        torch.cat([o[2].cpu() for o in outs], dim=1),
    )


def decode_corpus_sharded_lanes(
    blocks_t, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Lane-sharded corpus decode: the lane axis (files x channels) splits
    over the mesh's data-parallel axis; each device runs the lane-major
    decode (:func:`~bjxa_tpu_torch.ops.decode.decode_batch_lanes`, the
    lanes kernel on a card) on its own shard, zero communication.

    Args:
      blocks_t: ``uint8[B, S, L]`` lane-major raw blocks (host-staged).
      states:   ``int32[L, 2]``.

    Lanes are padded to the axis size; the pad is trimmed before return.

    Returns host tensors ``(pcm int16[B, 32, L], end int32[L, 2],
    valid bool[B, L])``.
    """
    devs = mesh.axis_devices(axis)
    blocks_t = np.asarray(blocks_t)
    L = blocks_t.shape[2]
    pad, shards = _lane_shards(L, len(devs))
    blocks_t = _pad_lanes(blocks_t, pad, 2)
    states = _pad_lanes(np.asarray(states, np.int32), pad, 0)
    outs = [
        decode_batch_lanes(_put(blocks_t[:, :, sl], d), _put(states[sl], d),
                           bits=bits)
        for sl, d in zip(shards, devs)
    ]
    pcm = torch.cat([o[0].cpu() for o in outs], dim=2)
    end = torch.cat([o[1].cpu() for o in outs])
    valid = torch.cat([o[2].cpu() for o in outs], dim=1)
    return pcm[:, :, :L], end[:L], valid[:, :L]


def decode_corpus_sharded_words(
    prof, words, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Packed-words lane-sharded corpus decode with flat per-shard results.

    The mesh twin of :func:`bjxa_tpu_torch.ops.decode.decode_batch_packed`:
    the lane axis (files x channels) shards over the mesh's data-parallel
    axis, each device runs the words kernel on its shard
    (:func:`~bjxa_tpu_torch.ops.decode.decode_batch_words`), and its PCM
    stays there as ONE flat int16 vector.

    Args:
      prof:   ``uint8[B, L]`` profile bytes (host-staged).
      words:  ``int32[B, bits, L]`` packed payload words.
      states: ``int32[L, 2]``.

    Returns ``(shards, reassemble)``: ``shards`` the per-device flat PCM
    tensors, in axis order and not yet read back (callers may start their
    readbacks), and ``reassemble(flat) -> int16[B, 32, L]`` undoing the
    shard-major layout of their host concatenation (:func:`host_flat`).
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    prof = np.asarray(prof)
    B, L = prof.shape
    pad, shards = _lane_shards(L, n)
    prof = _pad_lanes(prof, pad, 1)
    words = _pad_lanes(np.asarray(words, np.int32), pad, 2)
    states = _pad_lanes(np.asarray(states, np.int32), pad, 0)
    Lp = L + pad
    flat = [
        decode_batch_words(_put(prof[:, sl], d), _put(words[:, :, sl], d),
                           _put(states[sl], d), bits=bits)[0].reshape(-1)
        for sl, d in zip(shards, devs)
    ]

    def reassemble(flat: np.ndarray) -> np.ndarray:
        return (
            flat.reshape(n, B, BLOCK_SAMPLES, Lp // n)
            .transpose(1, 2, 0, 3)
            .reshape(B, BLOCK_SAMPLES, Lp)[:, :, :L]
        )

    return flat, reassemble


def _encode_shards(pcm_lanes, states, *, bits: int, search: bool,
                   mesh: Mesh, axis: str):
    """Shared body of the lane-sharded corpus encoders: per device, the
    80-profile search (through the fixed point where its lanes leave the
    card idle: :func:`~bjxa_tpu_torch.ops.encode.encode_search_auto`) or
    truncation over its lanes, then the bit-pack.  Returns ``(per-device
    uint8[B, L/n, S], L, Lp)``."""
    devs = mesh.axis_devices(axis)
    pcm_lanes = np.asarray(pcm_lanes)
    L = pcm_lanes.shape[2]
    pad, shards = _lane_shards(L, len(devs))
    pcm_lanes = _pad_lanes(pcm_lanes, pad, 2)
    states = _pad_lanes(np.asarray(states, np.int32), pad, 0)
    out = []
    for sl, d in zip(shards, devs):
        pcm = _put(pcm_lanes[:, :, sl], d)
        if search:
            profiles, coded, _recon, _end = encode_search_auto(
                pcm, _put(states[sl], d), bits=bits
            )
        else:
            profiles, coded = encode_truncate(pcm)
        # [B, 32, L] -> [B, L, 32] so packed bytes land channel-major
        # within each effective block (the file layout)
        out.append(deflate_blocks(profiles, coded.transpose(1, 2), bits))
    return out, L, L + pad


def encode_corpus_sharded_lanes(
    pcm_lanes, states, *, bits: int, search: bool, mesh: Mesh,
    axis: str = "dp"
):
    """Lane-sharded corpus encode: files x channels lanes split over the
    mesh's data-parallel axis; each device runs the 80-profile search (or
    truncation) plus bit-pack on its own lanes, zero communication -- the
    encode mirror of :func:`decode_corpus_sharded_lanes`.

    Args:
      pcm_lanes: int-like ``[B, 32, L]`` lane-major samples (zero-padded
        final block), host-staged.
      states:    ``int32[L, 2]`` initial predictor state per lane.

    Lanes are padded to the axis size; the pad is trimmed before return.

    Returns raw XA blocks as a host tensor ``uint8[B, L, block_size]``.
    """
    out, L, _Lp = _encode_shards(pcm_lanes, states, bits=bits, search=search,
                                 mesh=mesh, axis=axis)
    return torch.cat([b.cpu() for b in out], dim=1)[:, :L]


def encode_corpus_sharded_flat(
    pcm_lanes, states, *, bits: int, search: bool, mesh: Mesh,
    axis: str = "dp"
):
    """Lane-sharded corpus encode with flat per-shard results.

    Same computation as :func:`encode_corpus_sharded_lanes`, but each
    shard's packed blocks stay on its device as a flat uint8 vector.
    Returns ``(shards, reassemble)`` where ``reassemble(flat) ->
    uint8[B, L, block_size]`` undoes the shard-major layout of their host
    concatenation (:func:`host_flat`).
    """
    n = mesh.shape[axis]
    B = np.shape(pcm_lanes)[0]
    S = bits * 4 + 1
    out, L, Lp = _encode_shards(pcm_lanes, states, bits=bits, search=search,
                                mesh=mesh, axis=axis)

    def reassemble(flat: np.ndarray) -> np.ndarray:
        return (
            flat.reshape(n, B, Lp // n, S)
            .transpose(1, 0, 2, 3)
            .reshape(B, Lp, S)[:, :L]
        )

    return [b.reshape(-1) for b in out], reassemble


# --------------------------------------------------------------------------
# sequence parallel over one stream's block range
# --------------------------------------------------------------------------


def _changed(a: list, b: list) -> bool:
    """Whether any shard's entry state differs: one flag a device, then one
    host-side ``any`` (the ``psum`` of the JAX ring)."""
    flags = [torch.any(x != y) for x, y in zip(a, b)]
    return bool(torch.stack([f.cpu() for f in flags]).any())


def _ring(devs: list, state0: torch.Tensor, local_end):
    """The boundary fixed point over the device ring.

    ``local_end(i, entry) -> int32[C, 2]`` is shard ``i``'s exact end state
    from the entry state ``entry`` (on ``devs[i]``).  Shard 0 always enters
    at ``state0``, the others at zeros in the first round; each round hands
    every shard's end to the next shard, launching every shard's work
    before the round's one sync.  The loop goes on while a shard's entry
    changed and fewer than ``n`` rounds ran; after ``r`` rounds shards
    ``0..r`` are exact.  No state is written in place: ``Tensor.to`` onto
    the same device returns the tensor itself.

    Returns ``(entry states, one a shard, rounds)``; ``rounds`` counts the
    propagations, 1 after the first, as the JAX package counts them.
    """
    n = len(devs)
    anchor = state0.to(devs[0])

    def propagate(entries):
        ends = [local_end(i, entries[i]) for i in range(n)]
        return [anchor] + [ends[i - 1].to(devs[i], non_blocking=True)
                           for i in range(1, n)]

    prev = [anchor] + [torch.zeros_like(anchor, device=d) for d in devs[1:]]
    entries, rounds = propagate(prev), 1
    while rounds < n and _changed(entries, prev):
        prev, entries = entries, propagate(entries)
        rounds += 1
    return entries, rounds


def decode_file_sharded(
    blocks,
    state,
    *,
    bits: int,
    mesh: Mesh,
    axis: str = "sp",
    local_chunks: int = 16,
):
    """Decode one stream with its block range sharded across devices.

    Args:
      blocks: ``uint8[C, B, block_size]``; B is padded up to the device x
        chunk grid with valid dummy blocks.
      state:  ``int32[C, 2]`` initial predictor state from the header
        (numpy or a tensor on any device).
      local_chunks: intra-device chunk-parallel lanes per ring round.

    Each ring round runs :func:`~bjxa_tpu_torch.ops.decode.
    fixpoint_lanes_end_state` on every shard (the lanes kernel states-only
    on a card), the final pass :func:`~bjxa_tpu_torch.ops.decode.
    fixpoint_lanes_core` (the lanes kernel with output).

    Returns numpy ``(pcm int16[B*32, C], valid bool[B, C], rounds int)``.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    blocks = np.asarray(blocks, np.uint8)
    C, B, S = blocks.shape
    K = local_chunks
    grid = n * K
    Bp = -(-B // grid) * grid
    if Bp != B:
        pad = np.zeros((C, Bp - B, S), np.uint8)
        blocks = np.concatenate([blocks, pad], axis=1)

    # Host-stage the per-device chunk-lane layout (uint8[n, Bc, S, K*C],
    # lane l = k*C + c) so no device byte transposes run.
    Bc = Bp // grid
    blocks_lm = np.ascontiguousarray(
        blocks.reshape(C, n, K, Bc, S).transpose(1, 3, 4, 2, 0)
    ).reshape(n, Bc, S, K * C)
    shards = [_put(blocks_lm[i], d) for i, d in enumerate(devs)]

    entries, rounds = _ring(
        devs, torch.as_tensor(state, dtype=torch.int32),
        lambda i, entry: fixpoint_lanes_end_state(
            shards[i], entry, K, C, bits=bits),
    )
    outs = [
        fixpoint_lanes_core(shards[i], entries[i], K, C, K * Bc, bits=bits)
        for i in range(n)
    ]
    pcm = torch.cat([o[0].cpu() for o in outs]).numpy()
    valid = torch.cat([o[2].cpu() for o in outs]).numpy()
    return pcm[: B * BLOCK_SAMPLES], valid[:B], rounds


def encode_file_sharded(
    pcm,
    state,
    *,
    bits: int,
    mesh: Mesh,
    axis: str = "sp",
    local_chunks: int = 16,
    b_total: int | None = None,
):
    """Search-encode one stream with its block range sharded across devices.

    The encode mirror of :func:`decode_file_sharded`: the greedy
    80-profile search's only cross-block coupling is the 2-tap carried
    state (identical to the decoder's), so the same ring fixed point
    applies -- every device search-encodes its block range from a guessed
    entry state (its own chunk fixed point over
    :func:`~bjxa_tpu_torch.ops.encode.encode_search`, kernel 7 on a card),
    hands its exact end state one device forward, and the ring iterates
    until nothing changes.  Bit-identical to the sequential greedy search
    (reference anchor for the mirrored streaming-encode capability:
    ``src/bjxa_encode.c:108-160``).

    Args:
      pcm: int-like ``[B, 32, C]`` block-major samples (zero-padded final
        block); B is padded up to the device x chunk grid with zero
        blocks.
      state: ``int32[C, 2]`` entry predictor/search state (numpy or a
        tensor on any device).
      b_total: real block count if ``pcm`` already carries bucket pad
        (outputs are trimmed to it and the end state is read after block
        ``b_total - 1``); defaults to B.

    Returns numpy ``(blocks uint8[b_total, C, block_size], end int32[C, 2],
    rounds int)``: packed XA blocks in file order (bit-packed on each
    shard's device), the exact carried state after the last real block
    (read from the shard that owns it), and the ring-round count.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    arr = np.asarray(pcm).astype(np.int16)
    B, ns, C = arr.shape
    if b_total is None:
        b_total = B
    if not 0 < b_total <= B:
        raise ValueError(f"encode_file_sharded: b_total {b_total} of {B}"
                         " blocks")
    K = local_chunks
    grid = n * K
    Bp = -(-B // grid) * grid
    if Bp != B:
        arr = np.concatenate(
            [arr, np.zeros((Bp - B, ns, C), np.int16)], axis=0
        )

    # Host-stage the per-device chunk-lane layout (int16[n, Bc, 32, K*C],
    # lane l = k*C + c), mirroring decode_file_sharded's staging.
    Bc = Bp // grid
    pcm_lm = np.ascontiguousarray(
        arr.reshape(n, K, Bc, ns, C).transpose(0, 2, 3, 1, 4)
    ).reshape(n, Bc, ns, K * C)
    shards = [_put(pcm_lm[i], d) for i, d in enumerate(devs)]

    def search(i, states_flat):
        return encode_search(shards[i], states_flat, bits=bits)

    def local_states(i, entry):
        """Shard ``i``'s exact chunk entry states from its entry state."""
        states, _ = fixpoint_states(
            lambda s, _with_output: (None, search(i, s)[3]),
            entry, K, C, max_iters=K,
        )
        return states.reshape(K * C, 2)

    def local_end(i, entry):
        return search(i, local_states(i, entry))[3].reshape(K, C, 2)[-1]

    entries, rounds = _ring(
        devs, torch.as_tensor(state, dtype=torch.int32), local_end
    )
    # final full pass from the converged (exact) entry states
    finals = [search(i, local_states(i, entries[i])) for i in range(n)]
    packed = []
    for profiles, coded, _recon, _end in finals:
        # unscramble chunk lanes to this device's block order and pack
        prof_d = (profiles.reshape(Bc, K, C).permute(1, 0, 2)
                  .reshape(K * Bc, C))
        coded_d = (coded.reshape(Bc, ns, K, C).permute(2, 0, 3, 1)
                   .reshape(K * Bc, C, ns))
        packed.append(deflate_blocks(prof_d, coded_d, bits))

    # the reconstruction of the last real block, on the shard that owns it
    owner, rel = divmod(b_total - 1, K * Bc)
    k_idx, b_idx = divmod(rel, Bc)
    rec = finals[owner][2][b_idx, :, k_idx * C:(k_idx + 1) * C]
    end = torch.stack([rec[-1], rec[-2]], dim=-1).to(torch.int32)
    blocks = torch.cat([b.cpu() for b in packed]).numpy()
    return blocks[:b_total], end.cpu().numpy(), rounds
