"""XA encode pipelines.

Port of :mod:`bjxa_tpu.ops.encode`.  Two encoders:

* :func:`encode_truncate` — byte-compatible with the reference encoder,
  which performs *no* prediction: profile byte 0, keep the top ``bits`` of
  every sample (``src/libbjxa.c:665-691``).
* :func:`encode_search` — a greedy per-block exhaustive sweep of all 80
  filter profiles (5 factors x 16 ranges), each candidate running the
  *real* decoder recurrence so carried state is exact; the
  minimum-reconstruction-error candidate wins.  On a CUDA device it runs
  the search kernel (:mod:`bjxa_tpu_torch.ops.cuda_encode`), on the CPU its
  plain version.

Blocks stay sequential (state feedback), so one stream alone would give
the search only ``channels`` lanes.  :func:`encode_search_fixpoint` lifts
that to ``K * channels`` lanes with the decoder's boundary-state fixed
point, bit-identical to the sequential search (one cooperative launch of
``csrc/encode_fixpoint.cu`` on a CUDA device, a host loop of searches on
the CPU); :func:`pick_encode_chunks` chooses K, and
:func:`encode_search_auto` is the search every caller takes: the fixed
point where K > 1.  :func:`encode_stream_blocks` is what the whole-file
entry points call; :func:`iter_encode_segments` streams a file of any size
through the same encoders in fixed-size block segments (sharded over a
``mesh``'s sequence-parallel axis when it has several devices, by
:func:`bjxa_tpu_torch.parallel.sharded.encode_file_sharded`);
:func:`encode_batch_blocks` is the corpus engine's batch of many streams.  Every function works on the device of the tensors it is
given.  :func:`host_buffer` is a thread's reused host memory of the
whole-file encode, :func:`staged_to_device` and :func:`read_back` its
page-locked copies to and from a card: no fresh host memory once warm.
"""

from __future__ import annotations

import os
import threading
from functools import partial

import numpy as np
import torch

from bjxa_tpu_torch.errors import BjxaInvalidState
from bjxa_tpu_torch.ops.deflate import deflate_blocks
from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES, NUM_FACTORS, NUM_RANGES
from bjxa_tpu_torch.utils.profiler import span

NUM_CANDIDATES = NUM_FACTORS * NUM_RANGES  # 80


def _candidate_tables():
    """Static per-candidate tables: factor and range, in candidate order
    ``factor*16 + range``."""
    factor = np.repeat(np.arange(NUM_FACTORS), NUM_RANGES)
    rng = np.tile(np.arange(NUM_RANGES), NUM_FACTORS)
    return factor, rng


def encode_truncate(pcm: torch.Tensor):
    """Reference-compatible encode: profile 0, samples passed through.

    ``pcm``: int-like ``[B, 32, L]`` (zero-padded final block).
    Returns ``(profiles int32[B, L], coded int32[B, 32, L])`` where
    ``coded`` feeds :func:`bjxa_tpu_torch.ops.deflate.pack_payload` (which
    keeps the top bits, exactly like the reference's deflate callbacks).
    """
    B, _, L = pcm.shape
    profiles = torch.zeros((B, L), dtype=torch.int32, device=pcm.device)
    return profiles, pcm.to(torch.int32)


def encode_search(pcm: torch.Tensor, state: torch.Tensor, *, bits: int):
    """Greedy exhaustive profile-search encode (dispatcher).

    Args:
      pcm:   int-like ``[B, 32, L]`` target samples (zero-padded final
        block), on the CPU or a CUDA device.
      state: ``int32[L, 2]`` entry predictor state (zeros for a fresh
        stream, since the emitted header carries zero seeds).

    Returns ``(profiles int32[B, L], coded int16[B, 32, L],
    recon int16[B, 32, L], end_state int32[L, 2])`` on ``pcm``'s device
    (:func:`bjxa_tpu_torch.ops.cuda_encode.encode_search_lanes` routes).
    """
    from bjxa_tpu_torch.ops.cuda_encode import encode_search_lanes

    return encode_search_lanes(
        pcm.to(torch.int16).contiguous(),
        state.to(torch.int32).contiguous(),
        bits=bits,
    )


def encode_search_fixpoint(
    pcm: torch.Tensor,
    state: torch.Tensor,
    *,
    bits: int,
    num_chunks: int,
    run=None,
):
    """Chunk-parallel exact profile-search encode of ONE stream.

    The greedy search's only cross-block coupling is the 2-tap carried
    state, exactly like the decoder, so the decoder's boundary-state fixed
    point applies: split the block range into ``num_chunks`` chunks laid
    out as independent lanes, encode all chunks in parallel from guessed
    entry states, propagate each chunk's exact end state one chunk
    forward, and iterate until nothing changes.  Chunk 0 is anchored at the
    true entry state, so after r rounds chunks 0..r-1 are exactly right;
    the fixed point IS the sequential encode (bitwise), reached in at most
    ``num_chunks`` rounds.

    With ``run=None`` this is
    :func:`bjxa_tpu_torch.ops.cuda_encode.encode_search_fixpoint_lanes`: on
    a CUDA device ONE launch of the fixed-point kernel (the stream read and
    written in place) and one sync for the round count, on the CPU the host
    loop below over the plain search.  With ``run`` it is the host loop on
    any device: each round one ``run`` over ``K * C`` chunk lanes and one
    host sync (the integer equality test of the end states).  Both count
    the same rounds.

    Args:
      pcm:   int-like ``[B, 32, C]`` (zero-padded final block).
      state: ``int32[C, 2]`` entry state, on ``pcm``'s device.
      run:   ``run(lanes int16[Bc, 32, K*C], states int32[K*C, 2]) ->
        (profiles, coded, recon, end)``, the per-round search of the host
        loop.

    Returns ``(profiles int32[B, C], coded int16[B, 32, C],
    recon int16[B, 32, C], end_state int32[C, 2], rounds int)`` on
    ``pcm``'s device; ``B = 0`` runs no round and ends at ``state``.
    """
    if run is None:
        from bjxa_tpu_torch.ops.cuda_encode import (
            encode_search_fixpoint_lanes,
        )

        *out, rounds = encode_search_fixpoint_lanes(
            pcm.to(torch.int16).contiguous(),
            state.to(torch.int32).contiguous(), bits=bits,
            num_chunks=num_chunks,
        )
        return (*out, int(rounds.item()))
    B, ns, C = pcm.shape
    K = num_chunks
    dev = pcm.device
    if B == 0:
        return (*run(pcm, state), 0)
    Bc = -(-B // K)
    pad = K * Bc - B
    arr = pcm.to(torch.int16)
    if pad:
        arr = torch.cat(
            [arr, torch.zeros((pad, ns, C), dtype=torch.int16, device=dev)]
        )
    # lanes l = k*C + c (chunk-major, channel-minor), like the decoder
    lanes = (
        arr.reshape(K, Bc, ns, C).permute(1, 2, 0, 3).contiguous()
        .reshape(Bc, ns, K * C)
    )

    states = torch.zeros((K, C, 2), dtype=torch.int32, device=dev)
    states[0] = state.to(torch.int32)
    rounds = 0
    while rounds < K:
        prof, coded, recon, end = run(lanes, states.reshape(K * C, 2))
        new_states = torch.cat([states[:1], end.reshape(K, C, 2)[:-1]])
        rounds += 1
        if torch.equal(new_states, states):
            break
        states = new_states

    # unscramble chunk lanes back to stream order and trim the pad
    prof_s = prof.reshape(Bc, K, C).permute(1, 0, 2).reshape(K * Bc, C)[:B]
    coded_s, recon_s = (
        t.reshape(Bc, ns, K, C).permute(2, 0, 1, 3).reshape(K * Bc, ns, C)[:B]
        for t in (coded, recon)
    )
    # true end state: after the last REAL block (pad blocks, if any, all
    # live in the final chunk and are trimmed; their lanes' end states
    # are garbage, so recover from the reconstruction)
    end_s = torch.stack(
        [recon_s[B - 1, -1, :], recon_s[B - 1, -2, :]], dim=-1
    ).to(torch.int32)
    return prof_s, coded_s, recon_s, end_s, rounds


def pick_encode_chunks(nblocks: int, channels: int) -> int:
    """Chunk count K for :func:`encode_search_fixpoint`.

    The default is ``auto`` on every device: ``min(8192 // channels,
    nblocks // 16)`` chunks, so a long stream fills 8192 lanes and each
    chunk keeps at least 16 blocks (the fixed point converges in a few
    rounds).  A round costs one search over the chunk lanes plus one small
    host sync; on the CPU and on the card alike that is far cheaper than
    the ``nblocks``-long serial search over ``channels`` lanes (PERF.md).
    Streams of fewer than 64 blocks search sequentially.  The rule is the
    JAX package's, unchanged; :func:`encode_search_auto` applies it.

    ``BJXA_ENCODE_FIXPOINT_CHUNKS`` overrides: ``0``/``off`` forces
    sequential, ``auto`` the default, an integer forces K (clamped to
    ``nblocks // 16``); anything else raises :class:`BjxaInvalidState`.
    """
    env = os.environ.get("BJXA_ENCODE_FIXPOINT_CHUNKS", "")
    if env in ("0", "off"):
        return 1
    if nblocks < 64:
        return 1
    if env in ("", "auto"):
        return max(min(8192 // channels, nblocks // 16), 1)
    try:
        k = int(env)
    except ValueError:
        raise BjxaInvalidState(
            f"Invalid BJXA_ENCODE_FIXPOINT_CHUNKS {env!r}"
        )
    return max(min(k, nblocks // 16), 1)


class SearchOut(tuple):
    """What :func:`encode_search_auto` returns: its four outputs, as a
    tuple, and ``rounds``, the fixed point's (a one-element ``int32``
    tensor on the device from
    :func:`~bjxa_tpu_torch.ops.cuda_encode.encode_search_fixpoint_lanes`,
    not synced; an int from the host loop of ``run``; 1 on the sequential
    route).  On the fixed point's routes also ``items``, its K x L chunk
    items, and ``searched``, the items its rounds searched (that
    function's ``searched``; ``items x rounds`` from the host loop, which
    searches every item every round); both None on the sequential route."""

    def __new__(cls, outputs, rounds, searched=None, items=None):
        self = super().__new__(cls, outputs)
        self.rounds = rounds
        self.searched = searched
        self.items = items
        return self


def encode_search_auto(pcm: torch.Tensor, state: torch.Tensor, *, bits: int,
                       run=None) -> SearchOut:
    """The profile search of ``pcm`` int-like ``[B, 32, L]`` from ``state``
    ``int32[L, 2]``, as every encode path takes it: the fixed point at
    :func:`pick_encode_chunks` ``(B, L)`` chunks when that gives K > 1
    (:func:`bjxa_tpu_torch.ops.cuda_encode.encode_search_fixpoint_lanes`:
    on a CUDA device one launch, without a sync), else one sequential
    search (``run``, or :func:`encode_search`).  ``run`` replaces the
    per-round search as in :func:`encode_search_fixpoint` (its host loop
    then).  Bytes equal the sequential search either way.

    Returns ``(profiles int32[B, L], coded int16[B, 32, L],
    recon int16[B, 32, L], end int32[L, 2])`` on ``pcm``'s device, ``end``
    the state after block B - 1, as a :class:`SearchOut`.
    """
    B, _, L = pcm.shape
    K = pick_encode_chunks(B, L)
    if K == 1:
        return SearchOut((run or partial(encode_search, bits=bits))(
            pcm, state), 1)
    if run is None:
        from bjxa_tpu_torch.ops.cuda_encode import (
            encode_search_fixpoint_lanes,
        )

        found = encode_search_fixpoint_lanes(
            pcm.to(torch.int16).contiguous(),
            state.to(torch.int32).contiguous(), bits=bits, num_chunks=K,
        )
        *out, rounds = found
        searched = found.searched
    else:
        *out, rounds = encode_search_fixpoint(pcm, state, bits=bits,
                                              num_chunks=K, run=run)
        searched = K * L * rounds
    return SearchOut(out, rounds, searched, K * L)


def encode_stream_blocks(
    pcm: torch.Tensor, *, bits: int, search: bool, run=None
) -> torch.Tensor:
    """Encode one stream from the zero entry state to raw XA blocks.

    ``pcm``: int-like ``[B, 32, C]`` (zero-padded final block) on the
    device that does the work.  ``search`` picks the profile search
    (through the fixed point when :func:`pick_encode_chunks` gives K > 1)
    or truncation; ``run`` replaces the per-round search as in
    :func:`encode_search_fixpoint`.  Under a ``torch.profiler`` session
    the search is the span ``bjxa.ops.search`` (with the fixed point's
    ``rounds``, and on its routes its ``searched`` and ``items``) and the
    packing ``bjxa.ops.deflate``.

    Returns ``uint8[B, C, block_size]`` on ``pcm``'s device: channel-major
    inside each effective block, the file layout.
    """
    C = pcm.shape[2]
    if search:
        with span("bjxa.ops.search") as sp:
            state = torch.zeros((C, 2), dtype=torch.int32, device=pcm.device)
            found = encode_search_auto(pcm, state, bits=bits, run=run)
            if sp:
                if found.searched is None:
                    sp.set(rounds=found.rounds)
                else:
                    sp.set(rounds=found.rounds, searched=found.searched,
                           items=found.items)
        profiles, coded, _recon, _end = found
        del found  # untraced, the scratch that rounds views is freed here
    else:
        profiles, coded = encode_truncate(pcm)
    with span("bjxa.ops.deflate"):
        # [B, 32, C] -> [B, C, 32] so packed bytes land channel-major
        return deflate_blocks(profiles, coded.transpose(1, 2), bits)


def encode_batch_blocks(pcm: torch.Tensor, *, bits: int,
                        search: bool) -> torch.Tensor:
    """Corpus-batch encode: PCM lanes of many streams -> packed XA blocks.

    Every lane (file x channel) starts from the zero state the emitted
    headers carry.  ``search`` runs :func:`encode_search_auto` over all
    blocks and lanes: on a CUDA device ONE launch, of the fixed-point
    kernel when :func:`pick_encode_chunks` gives the batch K > 1 (a batch
    of 32 lanes would leave all but one SM idle in one serial search), of
    the search kernel otherwise.  Bytes equal per-file
    :func:`encode_stream_blocks` and the JAX package's one sequential
    search, since lanes never interact and the fixed point is exact.

    Args:
      pcm: int-like ``[B, 32, L]`` lane-major samples (zero-padded final
        block), on the device that does the work.

    Returns raw XA blocks as a FLAT ``uint8`` tensor on ``pcm``'s device
    (host layout ``[B, L, block_size]``: channel-major within each
    effective block, the file layout).
    """
    state = torch.zeros((pcm.shape[-1], 2), dtype=torch.int32,
                        device=pcm.device)
    if search:
        profiles, coded, _recon, _end = encode_search_auto(pcm, state,
                                                           bits=bits)
    else:
        profiles, coded = encode_truncate(pcm)
    return deflate_blocks(profiles, coded.transpose(1, 2), bits).reshape(-1)


class HostBuffer:
    """A ``uint8`` host buffer that one thread reuses for one role on one
    device: page-locked where the device is a CUDA card, so copies to and
    from it are DMA and may be ``non_blocking``.  It grows to the largest
    request so far and never shrinks, so once warm a call maps and faults
    in no fresh host memory.  :meth:`take` first waits for the copies of
    its last use (:meth:`used`)."""

    __slots__ = ("pinned", "data", "_done")

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.data: torch.Tensor | None = None
        self._done = None

    def take(self, nbytes: int) -> int:
        """Make :attr:`data` at least ``nbytes`` long, once the copies of
        its last use are done; returns the bytes it grew by (0 when it was
        long enough)."""
        if self._done is not None:
            self._done.synchronize()
        have = 0 if self.data is None else self.data.numel()
        if nbytes <= have:
            return 0
        self.data = None  # the old buffer goes back before the new one
        self.data = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=self.pinned)
        return nbytes - have

    def used(self, device: torch.device) -> None:
        """Note that copies enqueued on ``device``'s current stream read or
        write the buffer: the next :meth:`take` waits for them."""
        if self._done is None:
            self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(device))


_host_buffers = threading.local()


def host_buffer(role: str, device: torch.device | str) -> HostBuffer:
    """The calling thread's :class:`HostBuffer` for ``role`` on
    ``device`` (page-locked for a CUDA device), made empty on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    held = _host_buffers.__dict__.setdefault("by_key", {})
    buf = held.get((role, device))
    if buf is None:
        buf = held[(role, device)] = HostBuffer(device.type == "cuda")
    return buf


def staged_to_device(stage: HostBuffer, shape: tuple, device):
    """The ``int16`` PCM ``shape`` (``[B, 32, C]``) at the start of
    ``stage.data`` as a tensor on ``device``: on a CUDA device an H2D from
    the page-locked buffer on the current stream, without blocking (the
    buffer's next :meth:`~HostBuffer.take` waits for it); elsewhere the
    staged PCM itself."""
    device = torch.device(device)
    n = 2 * shape[0] * shape[1] * shape[2]
    host = stage.data[:n].view(torch.int16).view(shape)
    if device.type != "cuda":
        return host.to(device)
    lanes = torch.empty(shape, dtype=torch.int16, device=device)
    lanes.copy_(host, non_blocking=True)
    stage.used(device)
    return lanes


def read_back(blocks: torch.Tensor):
    """``blocks`` as a host array, and the bytes the copy's buffer grew
    by: from a CUDA device copied into the calling thread's page-locked
    ``"readback"`` :func:`host_buffer`, then the stream waited on (the
    array is a view of that buffer, valid until the thread's next
    readback); elsewhere ``blocks`` itself."""
    if blocks.device.type != "cuda":
        return blocks.cpu().numpy(), 0
    back = host_buffer("readback", blocks.device)
    grown = back.take(blocks.numel())
    out = back.data[: blocks.numel()].view(blocks.shape)
    out.copy_(blocks, non_blocking=True)
    torch.cuda.current_stream(blocks.device).synchronize()
    return out.numpy(), grown


def _encode_segment(lanes: torch.Tensor, state: torch.Tensor, nblocks: int,
                    *, bits: int, search: bool):
    """One segment of :func:`iter_encode_segments` on ``lanes``' device:
    ``lanes`` int16 ``[Bp, 32, C]`` (``nblocks`` real blocks, then the
    bucket's zero blocks) from the entry ``state``.  Returns the packed
    bytes of the real blocks and the exact state after the last of them."""
    if search:
        # the fixed point per segment where it pays (one launch on a card)
        profiles, coded, recon, _end = encode_search_auto(lanes, state,
                                                          bits=bits)
        # carried state = after the last REAL block of this segment (the
        # bucket's pad blocks would corrupt the search's own end state)
        state = torch.stack(
            [recon[nblocks - 1, -1, :], recon[nblocks - 1, -2, :]], dim=-1,
        ).to(torch.int32)
    else:
        profiles, coded = encode_truncate(lanes)
    blocks = deflate_blocks(profiles, coded.transpose(1, 2), bits)
    return blocks[:nblocks].cpu().numpy().tobytes(), state


def iter_encode_segments(
    read,
    channels: int,
    samples: int,
    *,
    bits: int,
    search: bool,
    device: torch.device | str,
    segment_blocks: int | None = None,
    mesh=None,
    sp_axis: str = "sp",
):
    """Bounded-memory encode on ``device``: stream PCM through it in
    fixed-size block segments, carrying the exact predictor/search state
    between segments.

    The profile search is greedy per block, so segmenting cannot change any
    choice: segment k+1 starts from the exact carried end state and the
    emitted bytes are bit-identical to the one-shot encoder at O(segment)
    peak memory -- the encode mirror of
    :func:`bjxa_tpu_torch.ops.decode.iter_decode_segments` (reference
    anchor: the streaming encode loop ``src/bjxa_encode.c:108-160`` with
    O(block) memory).

    Args:
      read: ``read(nbytes) -> bytes`` pulling little-endian int16
        interleaved PCM (a short result means the stream is truncated).
      samples: frames per channel the container header promises.

    With a ``mesh`` whose ``sp_axis`` has more than one device and
    ``search`` on, every segment's block range is sequence-parallel sharded
    across the mesh's devices instead
    (:func:`bjxa_tpu_torch.parallel.sharded.encode_file_sharded`): O(segment)
    host memory AND every device searching, still bit-identical to the
    sequential greedy search.

    Yields packed XA block bytes per segment.  On a truncated stream,
    yields the whole blocks that arrived (matching the streaming encoder's
    behavior), then raises :class:`EOFError`.
    """
    from bjxa_tpu_torch.ops.decode import (
        SEGMENT_BLOCKS,
        pad_bucket,
        use_sp_mesh,
    )
    from bjxa_tpu_torch.ops.tables import BLOCK_SAMPLES

    if segment_blocks is None:
        segment_blocks = SEGMENT_BLOCKS
    use_mesh = search and use_sp_mesh(mesh, sp_axis)
    device = torch.device(device)
    frame_bytes = 2 * channels
    state = torch.zeros((channels, 2), dtype=torch.int32, device=device)
    left = samples
    while left > 0:
        want_frames = min(segment_blocks * BLOCK_SAMPLES, left)
        body = read(want_frames * frame_bytes) or b""
        got = len(body) // frame_bytes
        truncated = got < want_frames
        if truncated:
            nblocks = got // BLOCK_SAMPLES  # whole blocks only mid-stream
            frames_used = nblocks * BLOCK_SAMPLES
        else:
            nblocks = -(-want_frames // BLOCK_SAMPLES)
            frames_used = want_frames
        if nblocks:
            # full segments share one shape; the tail buckets
            Bp = min(segment_blocks, pad_bucket(nblocks))
            arr = np.zeros((Bp * BLOCK_SAMPLES, channels), np.int16)
            arr[:frames_used] = np.frombuffer(
                body, "<i2", count=frames_used * channels
            ).reshape(-1, channels)
            lanes = arr.reshape(Bp, BLOCK_SAMPLES, channels)
            if use_mesh:
                # the ring encode of this segment's block range
                from bjxa_tpu_torch.parallel.sharded import (
                    encode_file_sharded,
                )

                blocks, end, _rounds = encode_file_sharded(
                    lanes, state, bits=bits, mesh=mesh, axis=sp_axis,
                    b_total=nblocks,
                )
                out, state = blocks.tobytes(), torch.from_numpy(end)
            else:
                out, state = _encode_segment(
                    torch.from_numpy(lanes).to(device), state, nblocks,
                    bits=bits, search=search,
                )
            yield out
        if truncated:
            raise EOFError("truncated PCM stream")
        left -= want_frames
