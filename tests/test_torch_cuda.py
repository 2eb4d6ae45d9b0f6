"""The CUDA kernels on the card against their plain PyTorch versions, and
the whole-file and segmented decode and encode and the corpus engine on the
card against the CPU.  Exact comparison.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import io
import struct

import numpy as np
import pytest
import torch

from bjxa_tpu_torch import (
    XAFormat,
    dump_riff_header,
    dump_xa_header,
    parse_xa_header,
    wav_to_xa,
)
from bjxa_tpu_torch.ops import (
    cuda_decode,
    cuda_decode_words,
    cuda_encode,
    cuda_filter,
)
from bjxa_tpu_torch.ops.decode import decode_bytes, words_from_blocks_host
from bjxa_tpu_torch.parallel.corpus import decode_corpus, encode_corpus
from bjxa_tpu_torch import (
    BjxaProtocolError,
    decode_xa_stream,
    encode_wav_stream,
    xa_to_wav,
)
from bjxa_tpu_torch.benchmarks import (
    _variants,
    load_variants,
    roofline_bound,
    store_variants,
)
from bjxa_tpu_torch.ops.decode import iter_decode_segments
from bjxa_tpu_torch.tools import encode_pack_falsify
from bjxa_tpu_torch.ops.filter import profile_gains

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(bits, B, L, seed, dev):
    rng = np.random.default_rng(seed)
    blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (
        rng.integers(0, 8, size=(B, L)) << 4 | rng.integers(0, 16, (B, L))
    ).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return torch.from_numpy(blocks_t).to(dev), torch.from_numpy(state).to(dev)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129)])
def test_decode_kernel_matches_plain(dev, bits, B, L):
    blocks_t, state = _lanes(bits, B, L, seed=bits + L, dev=dev)
    for wo in (True, False):
        before = cuda_decode.LAUNCHES
        pcm, end = cuda_decode.fused_decode_lanes(
            blocks_t, state, bits=bits, with_output=wo
        )
        assert cuda_decode.LAUNCHES == before + 1
        ppcm, pend = cuda_decode.fused_decode_lanes_plain(
            blocks_t, state, bits=bits, with_output=wo
        )
        torch.cuda.synchronize()
        assert torch.equal(end, pend)
        assert (pcm is None) == (not wo)
        if wo:
            assert torch.equal(pcm, ppcm)


@pytest.mark.parametrize("B,L", [(13, 1), (64, 2), (20, 300), (64, 8192)])
def test_filter_kernel_matches_plain(dev, B, L):
    rng = np.random.default_rng(B * L)
    samples = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(B, 32, L)).astype(np.int16)
    ).to(dev)
    prof = torch.from_numpy(rng.integers(0, 256, (B, L)).astype(np.int32))
    k0, k1, shift, _ = (t.to(dev) for t in profile_gains(prof))
    state = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    ).to(dev)
    for wo in (True, False):
        pcm, end = cuda_filter.adpcm_filter_kernel(
            samples, k0, k1, shift, state, with_output=wo
        )
        ppcm, pend = cuda_filter.adpcm_filter_plain(
            samples, k0, k1, shift, state, with_output=wo
        )
        torch.cuda.synchronize()
        assert torch.equal(end, pend)
        if wo:
            assert torch.equal(pcm, ppcm)


def _short_case(bits, channels, B, seed):
    """Fused-kernel inputs ``uint8[C, B, S]`` and ``int32[C, 2]`` on the
    CPU: random bytes, factors 0-4, ranges 0-15, a random entry state; a
    saturating first quarter (factor 1, range 0, the top-bits extremes)
    and an invalid profile at block B // 2 from 3 blocks on."""
    rng = np.random.default_rng(seed)
    S = 4 * bits + 1
    raw = rng.integers(0, 256, size=(channels, B, S), dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 5, size=(channels, B)) << 4
                    | rng.integers(0, 16, size=(channels, B))).astype(np.uint8)
    if B >= 3:
        raw[:, : max(1, B // 4), 0] = 0x10
        raw[0, : max(1, B // 4), 1:] = 0x7F if bits == 8 else 0x77
        raw[channels - 1, B // 2, 0] = 0x6B
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    return torch.from_numpy(raw), torch.from_numpy(state)


@pytest.mark.parametrize("B", [1, 2, 7, 15, 17, 23, 25, 49, 61])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_short_kernel_matches_plains(dev, bits, channels, B):
    """The fused short-stream kernel at each Bc of the sweep (1, 2, 4, 8 and
    B: K = 1) and at its default, with and without output: frames, end
    state and validity equal the sequential plain version's and the rounds
    the chunked plain version's, one launch each."""
    bt, st = _short_case(bits, channels, B, seed=B * 10 + bits + channels)
    want = cuda_filter.decode_short_plain(bt, st, bits=bits)
    bd, sd = bt.to(dev), st.to(dev)
    for chunks in sorted({-(-B // bc) for bc in (1, 2, 4, 8, B)}) + [None]:
        K = cuda_filter.pick_short_chunks(B)[0] if chunks is None else chunks
        rounds = cuda_filter.decode_short_chunked_plain(
            bt, st, bits=bits, chunks=K, with_output=False)[3]
        for wo in (True, False):
            before = cuda_filter.SHORT_LAUNCHES
            frames, end, valid, r = cuda_filter.fused_decode_short(
                bd, sd, bits=bits, chunks=chunks, with_output=wo)
            torch.cuda.synchronize()
            assert cuda_filter.SHORT_LAUNCHES == before + 1
            assert torch.equal(end.cpu(), want[1])
            assert torch.equal(valid.cpu(), want[2])
            assert int(r.item()) == rounds
            if wo:
                assert torch.equal(frames.cpu(), want[0])
            else:
                assert frames is None


def test_short_kernel_no_blocks(dev):
    bt = torch.zeros((2, 0, 33), dtype=torch.uint8, device=dev)
    st = torch.tensor([[5, -6], [7, -8]], dtype=torch.int32, device=dev)
    frames, end, valid, r = cuda_filter.fused_decode_short(bt, st, bits=8)
    torch.cuda.synchronize()
    assert frames.shape == (0, 2) and valid.shape == (0, 2)
    assert torch.equal(end, st) and int(r.item()) == 0


def test_short_wrapper_rejects_bad_inputs(dev):
    bt, st = (t.to(dev) for t in _short_case(6, 2, 5, seed=0))
    with pytest.raises(ValueError):
        cuda_filter.fused_decode_short(bt, st, bits=4)
    with pytest.raises(TypeError):
        cuda_filter.fused_decode_short(bt, st.long(), bits=6)
    with pytest.raises(ValueError):
        cuda_filter.fused_decode_short(bt, st.cpu(), bits=6)
    with pytest.raises(ValueError):
        cuda_filter.fused_decode_short(bt.transpose(0, 1), st, bits=6)
    # more blocks than one CTA's shared memory holds: refused, no fallback
    big = torch.zeros((2, 1000, 25), dtype=torch.uint8, device=dev)
    before = cuda_filter.SHORT_LAUNCHES
    with pytest.raises(RuntimeError):
        cuda_filter.fused_decode_short(big, st, bits=6)
    assert cuda_filter.SHORT_LAUNCHES == before


def test_short_xa_to_wav_is_one_fused_launch(dev):
    """A short stream's whole decode on the card is one launch of the
    fused kernel: the samples, lanes and stream kernels never launch."""
    data = _xa(8, 2, 23, seed=23)
    counters = (
        (cuda_filter, "SHORT_LAUNCHES"), (cuda_filter, "LAUNCHES"),
        (cuda_decode, "LAUNCHES"), (cuda_decode, "STREAM_LAUNCHES"))
    before = [getattr(m, n) for m, n in counters]
    wav = xa_to_wav(data, device=dev)
    after = [getattr(m, n) for m, n in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 0]
    assert wav == xa_to_wav(data, device="cpu")


def test_kernel_wrappers_reject_bad_inputs(dev):
    blocks_t, state = _lanes(6, 2, 8, seed=0, dev=dev)
    with pytest.raises(ValueError):
        cuda_decode.fused_decode_lanes(blocks_t, state, bits=4)
    with pytest.raises(TypeError):
        cuda_decode.fused_decode_lanes(blocks_t, state.long(), bits=6)
    with pytest.raises(ValueError):
        cuda_decode.fused_decode_lanes(blocks_t, state[:4], bits=6)
    samples = torch.zeros((2, 32, 8), dtype=torch.int32, device=dev)
    g = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_filter.adpcm_filter_kernel(samples, g, g, g, state)


def _xa(bits, channels, blocks, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(blocks, channels)) << 4
        | rng.integers(0, 13, size=(blocks, channels))
    ).astype(np.uint8)
    fmt = XAFormat(
        data_len=raw.size, samples=blocks * 32 - 5, samples_rate=44100,
        bits=bits, channels=channels, initial_state=((0, 0), (0, 0)),
    )
    hdr = bytearray(dump_xa_header(fmt))
    struct.pack_into("<4h", hdr, 20, 1000, -2000, 3000, -4000)
    return bytes(hdr) + raw.tobytes()


@pytest.mark.parametrize("bits,channels,blocks,kernel", [
    (6, 2, 5000, "decode"), (4, 1, 777, "decode"), (8, 2, 23, "filter"),
])
def test_decode_bytes_card_matches_cpu(dev, bits, channels, blocks, kernel):
    """A long stream takes exactly one stream-kernel launch and no launch
    of the lanes kernel; a short one exactly one launch of the fused
    short-stream kernel and none of the others."""
    data = _xa(bits, channels, blocks, seed=blocks)
    fmt = parse_xa_header(data)
    before = (cuda_decode.STREAM_LAUNCHES, cuda_decode.LAUNCHES,
              cuda_filter.LAUNCHES, cuda_filter.SHORT_LAUNCHES)
    got = decode_bytes(data[32:], fmt, device=dev)
    after = (cuda_decode.STREAM_LAUNCHES, cuda_decode.LAUNCHES,
             cuda_filter.LAUNCHES, cuda_filter.SHORT_LAUNCHES)
    if kernel == "decode":
        assert after == (before[0] + 1, before[1], before[2], before[3])
    else:
        assert after == (before[0], before[1], before[2], before[3] + 1)
    np.testing.assert_array_equal(
        got, decode_bytes(data[32:], fmt, device="cpu")
    )


def _encode_signals(rng, B, L):
    """``(pcm, state)`` pairs for the search kernel: full-scale noise from
    random entry states; the ranking contract's multiples of 1024 from
    random entry states (exact ties); a constant per lane entered from its
    own value, whose exact ties pit a lower range of a higher factor
    against a higher range of a lower factor (a tie-break by range index
    instead of candidate order picks wrong there)."""
    def state():
        return rng.integers(-(2**15), 2**15, size=(L, 2))

    noise = rng.integers(-(2**15), 2**15, size=(B, 32, L))
    ties = rng.integers(-14, 14, size=(B, 32, L)) * 1024
    c = rng.integers(-4096, 4097, size=L) >> rng.integers(0, 10, size=L)
    flat = np.ascontiguousarray(np.broadcast_to(c, (B, 32, L)))
    return [(noise, state()), (ties, state()),
            (flat, np.stack([c, c], axis=-1))]


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(3, 37), (64, 1), (1, 2), (5, 130),
                                 (4, 33), (3, 95), (3, 64), (2, 8192)])
def test_encode_kernel_matches_plain(dev, bits, B, L):
    """Ragged lane counts (the last CTA's masked threads still meet every
    barrier), one lane, a full grid, and each signal of ``_encode_signals``
    compared on all four outputs."""
    rng = np.random.default_rng(bits * 1000 + B * L)
    for x, st in _encode_signals(rng, B, L):
        pcm = torch.from_numpy(x.astype(np.int16)).to(dev)
        state = torch.from_numpy(st.astype(np.int32)).to(dev)
        before = cuda_encode.LAUNCHES
        got = cuda_encode.encode_search_lanes(pcm, state, bits=bits)
        assert cuda_encode.LAUNCHES == before + 1
        want = cuda_encode.encode_search_lanes_plain(pcm, state, bits=bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_encode_kernel_no_blocks(dev):
    """B = 0: no block runs and the entry state comes back as the end."""
    state = torch.tensor([[5, -7], [32767, -32768]], dtype=torch.int32,
                         device=dev)
    pcm = torch.zeros((0, 32, 2), dtype=torch.int16, device=dev)
    prof, coded, recon, end = cuda_encode.encode_search_lanes(
        pcm, state, bits=6)
    torch.cuda.synchronize()
    assert prof.shape == (0, 2) and coded.shape == recon.shape == (0, 32, 2)
    assert torch.equal(end, state)


def test_encode_kernel_rank_contract(dev):
    """Multiples of 1024 tie exactly and keep profile 0x00; a constant 1536
    is a near-tie that candidate 0x01 wins (tests/test_encode.py)."""
    rng = np.random.default_rng(11)
    ties = (rng.integers(-14, 14, size=(1, 32, 16)) * 1024).astype(np.int16)
    state = torch.zeros((16, 2), dtype=torch.int32, device=dev)
    for pcm, want in ((ties, 0), (np.full((1, 32, 16), 1536, np.int16), 1)):
        prof, *_ = cuda_encode.encode_search_lanes(
            torch.from_numpy(pcm).to(dev), state, bits=6
        )
        assert prof.cpu().reshape(-1).tolist() == [want] * 16


def test_encode_wrapper_rejects_bad_inputs(dev):
    pcm = torch.zeros((2, 32, 8), dtype=torch.int16, device=dev)
    state = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_encode.encode_search_lanes(pcm.int(), state, bits=6)
    with pytest.raises(TypeError):
        cuda_encode.encode_search_lanes(pcm, state.long(), bits=6)
    with pytest.raises(ValueError):
        cuda_encode.encode_search_lanes(pcm[:, :31], state, bits=6)
    with pytest.raises(ValueError):
        cuda_encode.encode_search_lanes(pcm, state[:4], bits=6)
    with pytest.raises(ValueError):
        cuda_encode.encode_search_lanes(pcm, state.cpu(), bits=6)
    with pytest.raises(ValueError):
        cuda_encode.encode_search_lanes(pcm.transpose(0, 2), state, bits=6)
    with pytest.raises(ValueError):
        cuda_encode.encode_search_lanes(pcm, state, bits=5)


# -- the search's chunk fixed point in one cooperative launch -----------------


def _fixpoint_case(B, L, seed, dev):
    """Sine plus noise a lane at its own pitch, and a random entry state."""
    rng = np.random.default_rng(seed)
    t = np.arange(B * 32)[:, None]
    sig = 14000 * np.sin(t / (4.0 + 0.7 * np.arange(L)))
    sig = sig + rng.normal(0, 2500, size=(B * 32, L))
    pcm = np.clip(sig, -32768, 32767).astype(np.int16).reshape(B, 32, L)
    state = rng.integers(-30000, 30000, size=(L, 2)).astype(np.int32)
    return torch.from_numpy(pcm).to(dev), torch.from_numpy(state).to(dev)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L,K", [
    (101, 2, 6),     # short last chunk (5 x 17 + 16)
    (101, 33, 7),    # L not a multiple of 32: tiles straddle chunks
    (101, 2, 33),    # Bc = 4: seven whole chunks of pad
    (64, 1, 4),      # the first block count that takes K > 1
    (37, 45, 1),     # K = 1: no round, the pass with output alone
    (300, 3, 37),    # more tiles than one CTA, a short last chunk
    (0, 2, 1),       # no blocks
])
def test_encode_fixpoint_kernel_matches_plain(dev, bits, B, L, K):
    """The fixed-point kernel against its plain version (the host loop on
    the CPU): all four outputs and the round count, one launch."""
    pcm, state = _fixpoint_case(B, L, seed=bits * 1000 + B + L + K, dev=dev)
    before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
    got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=bits,
                                                   num_chunks=K)
    assert (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES) == (
        before[0], before[1] + 1)
    want = cuda_encode.encode_search_fixpoint_lanes_plain(
        pcm.cpu(), state.cpu(), bits=bits, num_chunks=K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_encode_fixpoint_kernel_no_lanes(dev):
    """L = 0: empty outputs, no launch, no round."""
    pcm = torch.zeros((5, 32, 0), dtype=torch.int16, device=dev)
    state = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    before = cuda_encode.FIXPOINT_LAUNCHES
    prof, coded, recon, end, rounds = (
        cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                 num_chunks=2))
    assert cuda_encode.FIXPOINT_LAUNCHES == before
    assert prof.shape == (5, 0) and end.shape == (0, 2)
    assert rounds.cpu().tolist() == [0]


def test_encode_fixpoint_kernel_matches_serial_at_the_corpus_batch(dev):
    """The encode corpus's batch shape (B = 13,824, L = 32, K = 256): the
    fixed point's bytes equal the serial kernel's, and its rounds the host
    loop's on the card (kernel 7 a round, ``run=`` given)."""
    from bjxa_tpu_torch.ops import encode

    B, L = 13824, 32
    pcm, _ = _fixpoint_case(B, L, seed=3, dev=dev)
    state = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    K = encode.pick_encode_chunks(B, L)
    assert K == 256
    got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                   num_chunks=K)
    serial = cuda_encode.encode_search_lanes(pcm, state, bits=6)
    for g, s in zip(got, serial):
        assert torch.equal(g, s)
    before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
    *loop, rounds = encode.encode_search_fixpoint(
        pcm, state, bits=6, num_chunks=K,
        run=lambda lanes, st: cuda_encode.encode_search_lanes(lanes, st,
                                                              bits=6))
    assert (cuda_encode.LAUNCHES - before[0],
            cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (rounds, 0)
    assert int(got[4].item()) == rounds
    for g, lp in zip(got, loop):
        assert torch.equal(g, lp)


def test_encode_search_fixpoint_routes_by_run(dev):
    """``encode_search_fixpoint`` on a CUDA tensor: one fixed-point launch
    without ``run``, the host loop (a serial launch a round) with it; the
    same outputs and rounds."""
    from functools import partial

    from bjxa_tpu_torch.ops import encode

    pcm, state = _fixpoint_case(700, 2, seed=4, dev=dev)
    before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
    *one, rounds = encode.encode_search_fixpoint(pcm, state, bits=6,
                                                 num_chunks=43)
    assert (cuda_encode.LAUNCHES - before[0],
            cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (0, 1)
    before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
    *loop, loop_rounds = encode.encode_search_fixpoint(
        pcm, state, bits=6, num_chunks=43,
        run=partial(encode.encode_search, bits=6))
    assert (cuda_encode.LAUNCHES - before[0],
            cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (loop_rounds, 0)
    assert rounds == loop_rounds
    for a, b in zip(one, loop):
        assert torch.equal(a, b)


def _wav(channels, frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None]
    sig = 9000 * np.sin(2 * np.pi * t / 41.0) + rng.normal(
        0, 1500, size=(frames, channels)
    )
    pcm = np.clip(sig, -32768, 32767).astype("<i2")
    return dump_riff_header(pcm.size * 2, 44100, channels) + pcm.tobytes()


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_to_xa_card_matches_cpu(dev, bits, channels):
    """A fixpoint-length stream (one launch of the fixed-point kernel) and
    a short one (one of the sequential search), search and truncation."""
    for frames, fixpoint in ((300 * 32 + 7, 1), (23 * 32 - 5, 0)):
        wav = _wav(channels, frames, seed=bits * channels + frames)
        before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
        got = wav_to_xa(wav, bits, device=dev)
        assert (cuda_encode.LAUNCHES - before[0],
                cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (
                    1 - fixpoint, fixpoint)
        assert got == wav_to_xa(wav, bits, device="cpu")
        assert wav_to_xa(wav, bits, search=False, device=dev) == wav_to_xa(
            wav, bits, search=False, device="cpu"
        )


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129), (300, 3)])
def test_words_kernel_matches_plain(dev, bits, B, L):
    blocks_t, state = _lanes(bits, B, L, seed=bits * 7 + L, dev="cpu")
    prof, words = words_from_blocks_host(blocks_t.numpy(), bits)
    prof = torch.from_numpy(prof).to(dev)
    words = torch.from_numpy(words).to(dev)
    state = state.to(dev)
    for wo in (True, False):
        before = cuda_decode_words.LAUNCHES
        pcm, end = cuda_decode_words.fused_decode_words(
            prof, words, state, bits=bits, with_output=wo
        )
        assert cuda_decode_words.LAUNCHES == before + 1
        ppcm, pend = cuda_decode_words.fused_decode_words_plain(
            prof, words, state, bits=bits, with_output=wo
        )
        torch.cuda.synchronize()
        assert torch.equal(end, pend)
        assert (pcm is None) == (not wo)
        if wo:
            assert torch.equal(pcm, ppcm)


def test_words_wrapper_rejects_bad_inputs(dev):
    prof = torch.zeros((2, 8), dtype=torch.uint8, device=dev)
    words = torch.zeros((2, 6, 8), dtype=torch.int32, device=dev)
    state = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    bad = [
        (prof.int(), words, state, 6, TypeError),
        (prof, words.long(), state, 6, TypeError),
        (prof, words, state.long(), 6, TypeError),
        (prof, words, state, 4, ValueError),
        (prof, words, state, 5, ValueError),
        (prof[:1], words, state, 6, ValueError),
        (prof, words, state[:4], 6, ValueError),
        (prof, words, state.cpu(), 6, ValueError),
        (prof, words.transpose(0, 2).contiguous().transpose(0, 2), state, 6,
         ValueError),
    ]
    for p, w, st, bits, exc in bad:
        with pytest.raises(exc):
            cuda_decode_words.fused_decode_words(p, w, st, bits=bits)


def _words_case(bits, B, L, seed, dev, slow=False):
    """Words-layout inputs on ``dev``: random payload and profiles with
    factors 0-7 (5-7 invalid), or (``slow``) the slow-merging stream --
    factor 4, range 12, payload bytes near zero; int16-range states."""
    rng = np.random.default_rng(seed)
    blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (rng.integers(0, 8, size=(B, L)) << 4
                         | rng.integers(0, 16, size=(B, L))).astype(np.uint8)
    if slow:
        blocks_t[:, 1:, :] = rng.choice(
            np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8),
            size=(B, 4 * bits, L))
        blocks_t[:, 0, :] = 4 << 4 | 12
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    prof, words = words_from_blocks_host(blocks_t, bits)
    return tuple(torch.from_numpy(a).to(dev) for a in (prof, words, state))


def _chunked_equals_plains(prof, words, state, bits, chunks):
    """The kernel at ``chunks`` against the chunked plain version (PCM, end
    and rounds) and the sequential one, with and without output.  Returns
    the kernel's rounds."""
    cdw = cuda_decode_words
    K, _Bc = cdw.word_chunks(words.shape[0], chunks)
    for wo in (True, False):
        before = cdw.LAUNCHES
        pcm, end, rounds = cdw.fused_decode_words_chunked(
            prof, words, state, bits=bits, with_output=wo, chunks=chunks)
        assert cdw.LAUNCHES == before + 1
        ppcm, pend, prounds = cdw.fused_decode_words_chunked_plain(
            prof, words, state, bits=bits, chunks=chunks, with_output=wo)
        spcm, send = cdw.fused_decode_words_plain(prof, words, state,
                                                  bits=bits, with_output=wo)
        torch.cuda.synchronize()
        assert int(rounds.item()) == prounds
        assert (prounds == 0) if K == 1 else (1 <= prounds <= K)
        assert torch.equal(end, pend) and torch.equal(end, send)
        assert (pcm is None) == (not wo)
        if wo:
            assert torch.equal(pcm, ppcm) and torch.equal(pcm, spcm)
    return prounds


@pytest.mark.parametrize("K", [1, 3, 7, 23])
@pytest.mark.parametrize("L", [1, 2, 32, 33])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_words_kernel_chunks_match_plains(dev, bits, L, K):
    """Forced K over B = 23 (a short last chunk unless K is 1 or 23),
    invalid profiles in mid-stream."""
    prof, words, state = _words_case(bits, 23, L, bits * 100 + L, dev)
    _chunked_equals_plains(prof, words, state, bits, K)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_words_kernel_slow_merging_stream(dev, bits):
    prof, words, state = _words_case(bits, 23, 33, bits, dev, slow=True)
    assert 2 < _chunked_equals_plains(prof, words, state, bits, 23) <= 23


@pytest.mark.parametrize("bits,B,L,K", [
    (8, 0, 1, 5),  # no blocks: end = state, no round
    (6, 1, 1, 4),  # one block, one lane
    (8, 64, 32768, 1),  # the headline, K = 1
    (6, 300, 3, 1),  # forced K = 1 at few lanes: the serial loop
    (8, 512, 32, 64),  # corpus chunking, Bc = 8
])
def test_words_kernel_shapes_match_plains(dev, bits, B, L, K):
    prof, words, state = _words_case(bits, B, L, B + L, dev)
    _chunked_equals_plains(prof, words, state, bits, K)


def test_words_kernel_grid_smaller_than_items(dev):
    """More work items than the persistent grid has threads: threads take
    several items, every round."""
    cdw = cuda_decode_words
    bits, B, L, K = 4, 300, 8191, 37
    items = cdw.word_chunks(B, K)[0] * L
    ctas = cdw.persistent_ctas(items, bits=bits, with_output=True, device=dev)
    assert ctas * cdw.CTA_THREADS < items
    prof, words, state = _words_case(bits, B, L, 7, dev)
    _chunked_equals_plains(prof, words, state, bits, K)


def test_words_kernel_default_chunks(dev):
    """The wrapper's own K at a corpus-like shape (32 lanes) equals
    pick_word_chunks and decodes like the sequential plain version."""
    cdw = cuda_decode_words
    bits, B, L = 8, 1024, 32
    prof, words, state = _words_case(bits, B, L, 11, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K = cdw.pick_word_chunks(B, L, sms)
    assert K > 1
    pcm, end, rounds = cdw.fused_decode_words_chunked(prof, words, state,
                                                      bits=bits)
    ppcm, pend, prounds = cdw.fused_decode_words_chunked_plain(
        prof, words, state, bits=bits, chunks=K)
    torch.cuda.synchronize()
    assert torch.equal(pcm, ppcm) and torch.equal(end, pend)
    assert int(rounds.item()) == prounds


def test_words_kernel_refused_launch_raises(dev, monkeypatch):
    """A cooperative grid larger than the card holds at once is refused,
    and the wrapper raises; nothing falls back."""
    cdw = cuda_decode_words
    prof, words, state = _words_case(8, 64, 4096, 3, dev)
    fit = cdw.persistent_ctas(1 << 40, bits=8, with_output=True, device=dev)
    monkeypatch.setattr(cdw, "persistent_ctas", lambda *a, **k: fit + 1)
    before = cdw.LAUNCHES
    with pytest.raises(RuntimeError, match="bjxa_decode_words"):
        cdw.fused_decode_words_chunked(prof, words, state, bits=8, chunks=4)
    assert cdw.LAUNCHES == before


# -- the stream kernel: a whole stream in the file's own byte layout ----------


def _stream_case(bits, channels, B, seed, dev, slow=False):
    """``(payload uint8[B*C*S], state int32[C, 2])`` on ``dev``: random
    payload and profiles with factors 0-7 (5-7 invalid), or (``slow``) the
    slow-merging stream -- factor 4, range 12, payload bytes near zero."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(B, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (rng.integers(0, 8, size=(B, channels)) << 4
                    | rng.integers(0, 16, size=(B, channels))).astype(np.uint8)
    if slow:
        raw[:, :, 1:] = rng.choice(np.array([0x00, 0x11, 0xEE, 0xFF],
                                            np.uint8),
                                   size=(B, channels, 4 * bits))
        raw[:, :, 0] = 4 << 4 | 12
    state = rng.integers(-(2**15), 2**15, size=(channels, 2))
    return (torch.from_numpy(raw.reshape(-1).copy()).to(dev),
            torch.from_numpy(state.astype(np.int32)).to(dev))


def _stream_equals_plains(payload, state, bits, channels, chunks,
                          sequential=True):
    """The stream kernel at ``chunks`` (None: its own pick), with and
    without output, against the chunked plain version (frames,
    end and rounds) and the sequential one.  Returns the rounds."""
    cd = cuda_decode
    B = payload.numel() // (channels * (4 * bits + 1))
    sms = torch.cuda.get_device_properties(payload.device).multi_processor_count
    K = (cd.word_chunks(B, chunks)[0] if chunks is not None
         else cd.pick_stream_chunks(B, channels, sms)[0])
    if sequential:
        seq = {wo: cd.fused_decode_stream_plain(
            payload, state, bits=bits, channels=channels, with_output=wo)
            for wo in (True, False)}
    for wo in (True, False):
        before = cd.STREAM_LAUNCHES
        frames, end, rounds = cd.fused_decode_stream(
            payload, state, bits=bits, channels=channels, with_output=wo,
            chunks=chunks)
        assert cd.STREAM_LAUNCHES == before + 1
        pframes, pend, prounds = cd.fused_decode_stream_chunked_plain(
            payload, state, bits=bits, channels=channels, chunks=K,
            with_output=wo)
        torch.cuda.synchronize()
        assert int(rounds.item()) == prounds
        assert (prounds == 0) if K == 1 else (1 <= prounds <= K)
        assert torch.equal(end, pend)
        assert (frames is None) == (not wo)
        if wo:
            assert tuple(frames.shape) == (B * 32, channels)
            assert torch.equal(frames, pframes)
        if sequential:
            sframes, send = seq[wo]
            assert torch.equal(end, send)
            if wo:
                assert torch.equal(frames, sframes)
    return prounds


@pytest.mark.parametrize("B,chunks", [
    (97, None),  # its own K: 13 chunks of 8, the last of 1 block
    (97, 7),  # a short last chunk of 13 blocks
    (1000, 125),
    (1, 1),
])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_stream_kernel_matches_plains(dev, bits, channels, B, chunks):
    payload, state = _stream_case(bits, channels, B, 10 * B + bits, dev)
    _stream_equals_plains(payload, state, bits, channels, chunks)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_stream_kernel_slow_merging_stream(dev, bits, channels):
    payload, state = _stream_case(bits, channels, 23, bits, dev, slow=True)
    assert 2 < _stream_equals_plains(payload, state, bits, channels, 23) <= 23


@pytest.mark.parametrize("channels", [1, 2])
def test_stream_kernel_no_blocks(dev, channels):
    payload = torch.empty(0, dtype=torch.uint8, device=dev)
    state = torch.tensor([[5, -6], [7, -8]][:channels], dtype=torch.int32,
                         device=dev)
    for wo in (True, False):
        frames, end, rounds = cuda_decode.fused_decode_stream(
            payload, state, bits=8, channels=channels, with_output=wo)
        torch.cuda.synchronize()
        assert torch.equal(end, state) and int(rounds.item()) == 0
        assert (frames is None) == (not wo)
        if wo:
            assert tuple(frames.shape) == (0, channels)


def test_stream_kernel_grid_smaller_than_items(dev):
    """More work items than the persistent grid has threads (one block a
    chunk over 100,000 blocks of stereo): threads take several items, every
    round."""
    cd = cuda_decode
    bits, channels, B = 4, 2, 100_000
    ctas = cd.stream_ctas(B * channels, bits=bits, channels=channels,
                          with_output=True, device=dev)
    assert ctas * cd.CTA_THREADS < B * channels
    payload, state = _stream_case(bits, channels, B, 5, dev)
    _stream_equals_plains(payload, state, bits, channels, B,
                          sequential=False)


def test_stream_kernel_at_the_main_path_shape(dev):
    """The 5-minute stereo 6-bit stream at the wrapper's own K."""
    payload, state = _stream_case(6, 2, 413_438, 6, dev)
    _stream_equals_plains(payload, state, 6, 2, None, sequential=False)


def test_stream_wrapper_rejects_bad_inputs(dev):
    cd = cuda_decode
    payload = torch.zeros(4 * 2 * 25, dtype=torch.uint8, device=dev)
    state = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    bad = [
        (payload.int(), state, 6, 2, {}, TypeError),
        (payload, state.long(), 6, 2, {}, TypeError),
        (payload, state, 5, 2, {}, ValueError),
        (payload, state, 6, 3, {}, ValueError),
        (payload[:-1], state, 6, 2, {}, ValueError),
        (payload[1:].contiguous(), state, 6, 2, {}, ValueError),
        (payload.view(4, 50), state, 6, 2, {}, ValueError),
        (payload, state[:1], 6, 2, {}, ValueError),
        (payload, state.cpu(), 6, 2, {}, ValueError),
        (payload, state, 6, 2, {"chunks": 0}, ValueError),
        (payload.cpu(), state.cpu(), 6, 2, {}, ValueError),
    ]
    before = cd.STREAM_LAUNCHES
    for p, st, bits, ch, kw, exc in bad:
        with pytest.raises(exc):
            cd.fused_decode_stream(p, st, bits=bits, channels=ch, **kw)
    # a payload that starts off a 4-byte boundary
    with pytest.raises(ValueError, match="4-byte"):
        cd.fused_decode_stream(
            torch.zeros(4 * 50 + 1, dtype=torch.uint8, device=dev)[1:],
            state, bits=6, channels=2)
    assert cd.STREAM_LAUNCHES == before


def test_stream_refused_launch_raises(dev, monkeypatch):
    """A cooperative grid larger than the card holds at once is refused,
    and the wrapper raises; nothing falls back."""
    cd = cuda_decode
    payload, state = _stream_case(8, 2, 4096, 3, dev)
    fit = cd.stream_ctas(1 << 40, bits=8, channels=2, with_output=True,
                         device=dev)
    monkeypatch.setattr(cd, "stream_ctas", lambda *a, **k: fit + 1)
    before = cd.STREAM_LAUNCHES
    with pytest.raises(RuntimeError, match="bjxa_decode_stream"):
        cd.fused_decode_stream(payload, state, bits=8, channels=2, chunks=4)
    assert cd.STREAM_LAUNCHES == before


def test_stream_path_makes_no_host_sync(dev):
    """The stream kernel's wrapper and the card branch of the whole-file
    decode, up to its readback, call nothing that synchronizes with the
    card."""
    from bjxa_tpu_torch.ops.decode import _decode_payload

    data = _xa(6, 2, 5000, seed=12)
    fmt = parse_xa_header(data)
    state = torch.from_numpy(fmt.initial_state_array()).to(dev)
    payload, pstate = _stream_case(6, 2, 3000, 4, dev)
    # warm: the build, the library and the occupancy queries
    cuda_decode.fused_decode_stream(payload, pstate, bits=6, channels=2)
    _decode_payload(memoryview(data)[32:], fmt, state, dev)
    torch.cuda.synchronize()
    before = cuda_decode.STREAM_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        cuda_decode.fused_decode_stream(payload, pstate, bits=6, channels=2)
        frames, valid = _decode_payload(memoryview(data)[32:], fmt, state,
                                        dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_decode.STREAM_LAUNCHES == before + 2
    np.testing.assert_array_equal(
        frames[: fmt.samples].cpu().numpy(),
        decode_bytes(data[32:], fmt, device="cpu"))
    assert bool(valid.all())


def test_decode_corpus_card_matches_cpu(dev, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i, (bits, ch, blocks) in enumerate(
        [(4, 1, 300), (6, 2, 290), (6, 2, 257), (8, 2, 40), (8, 1, 999)]
    ):
        (src / f"f{i}.xa").write_bytes(_xa(bits, ch, blocks, seed=i))
    bad = bytearray(_xa(6, 2, 100, seed=9))
    bad[32 + 7 * 50] = 0xF0
    (src / "bad.xa").write_bytes(bytes(bad))
    (src / "cut.xa").write_bytes(_xa(4, 2, 80, seed=10)[:-20])
    before = cuda_decode_words.LAUNCHES
    card = decode_corpus(src, tmp_path / "card", device=dev, batch_files=2,
                         bucket_granularity=16)
    assert cuda_decode_words.LAUNCHES > before
    cpu = decode_corpus(src, tmp_path / "cpu", device="cpu", batch_files=2,
                        bucket_granularity=16)
    assert (card.converted, card.failed) == (cpu.converted, cpu.failed)
    assert card.converted == 5 and len(card.failed) == 2
    for p in sorted((tmp_path / "cpu").glob("*.wav")):
        assert (tmp_path / "card" / p.name).read_bytes() == p.read_bytes()


def test_encode_corpus_card_matches_cpu(dev, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i, (ch, frames) in enumerate([(1, 3000), (2, 2500), (2, 99)]):
        (src / f"w{i}.wav").write_bytes(_wav(ch, frames, seed=i))
    for search in (True, False):
        before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
        card = encode_corpus(src, tmp_path / f"card{search}", device=dev,
                             search=search, batch_files=2,
                             bucket_granularity=16)
        # batches by channel count: the mono file (96 blocks) and the long
        # stereo one (80) through the fixed point, the short stereo one (16)
        # through the sequential search
        assert (cuda_encode.LAUNCHES - before[0],
                cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (
                    search, 2 * search)
        cpu = encode_corpus(src, tmp_path / f"cpu{search}", device="cpu",
                            search=search, batch_files=2,
                            bucket_granularity=16)
        assert card.converted == cpu.converted == 3
        for p in sorted((tmp_path / f"cpu{search}").glob("*.xa")):
            assert (tmp_path / f"card{search}" / p.name).read_bytes() == (
                p.read_bytes()
            )


# -- the measurement kernels --------------------------------------------------


@pytest.mark.parametrize("store", ["i16", "pair"])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129), (300, 3)])
def test_load_variant_kernel_matches_plain(dev, store, B, L):
    blocks_t, state = _lanes(8, B, L, seed=B + L, dev="cpu")
    prof, words = words_from_blocks_host(blocks_t.numpy(), 8)
    prof, words = torch.from_numpy(prof).to(dev), torch.from_numpy(words).to(dev)
    state = state.to(dev)
    before = load_variants.LAUNCHES
    out, end = load_variants.decode_w32(prof, words, state, store=store)
    assert load_variants.LAUNCHES == before + 1
    pout, pend = load_variants.decode_w32_plain(prof, words, state,
                                                store=store)
    ref, ref_end = cuda_decode_words.fused_decode_words(prof, words, state,
                                                        bits=8)
    torch.cuda.synchronize()
    assert out.dtype == pout.dtype and torch.equal(out, pout)
    assert torch.equal(end, pend) and torch.equal(end, ref_end)
    as_i16 = out if store == "i16" else _variants.pair_to_i16(out)
    assert torch.equal(as_i16, ref)


@pytest.mark.parametrize("mode", ["i16", "i32", "pair"])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129), (300, 3)])
def test_store_variant_kernel_matches_plain(dev, mode, B, L):
    blocks_t, state = _lanes(8, B, L, seed=2 * B + L, dev=dev)
    before = store_variants.LAUNCHES
    out, end = store_variants.decode_variant(blocks_t, state, mode=mode)
    assert store_variants.LAUNCHES == before + 1
    pout, pend = store_variants.decode_variant_plain(blocks_t, state,
                                                     mode=mode)
    ref, ref_end = cuda_decode.fused_decode_lanes(blocks_t, state, bits=8)
    torch.cuda.synchronize()
    assert out.dtype == pout.dtype and torch.equal(out, pout)
    assert torch.equal(end, pend) and torch.equal(end, ref_end)
    as_i16 = (_variants.pair_to_i16(out) if mode == "pair"
              else out.to(torch.int16))
    assert torch.equal(as_i16, ref)


#: The five instantiations of the variants kernel, (load, store).
VARIANTS = [("w32", "i16"), ("w32", "pair"), ("u8", "i16"), ("u8", "i32"),
            ("u8", "pair")]


def _variant_chunked_equals_plains(load, store, blocks_t, state, chunks):
    """One instantiation at ``chunks`` against its chunked plain version
    (out, end and rounds) and its sequential one, and its int16 view
    against the production kernel of its load (the words kernel for
    ``w32``, the lanes kernel for ``u8``), bit for bit.  Returns the
    rounds."""
    B = blocks_t.shape[0]
    K, _Bc = cuda_decode_words.word_chunks(B, chunks)
    if load == "w32":
        prof, words = (torch.from_numpy(a).to(blocks_t.device) for a in
                       words_from_blocks_host(blocks_t.cpu().numpy(), 8))
        mod, args = load_variants, (prof, words, state)
        before = mod.LAUNCHES
        out, end, rounds = mod.decode_w32_chunked(*args, store=store,
                                                  chunks=chunks)
        pout, pend, prounds = mod.decode_w32_chunked_plain(
            *args, store=store, chunks=chunks)
        sout, send = mod.decode_w32_plain(*args, store=store)
        ref, ref_end, ref_rounds = (
            cuda_decode_words.fused_decode_words_chunked(*args, bits=8,
                                                         chunks=chunks))
    else:
        mod, args = store_variants, (blocks_t, state)
        before = mod.LAUNCHES
        out, end, rounds = mod.decode_variant_chunked(*args, mode=store,
                                                      chunks=chunks)
        pout, pend, prounds = mod.decode_variant_chunked_plain(
            *args, mode=store, chunks=chunks)
        sout, send = mod.decode_variant_plain(*args, mode=store)
        # the lanes kernel takes no empty stream: its plain version then
        ref, ref_end = (cuda_decode.fused_decode_lanes if B else
                        cuda_decode.fused_decode_lanes_plain)(*args, bits=8)
        ref_rounds = None
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    assert out.dtype == pout.dtype and torch.equal(out, pout)
    assert torch.equal(out, sout)
    assert torch.equal(end, pend) and torch.equal(end, send)
    assert torch.equal(end, ref_end)
    assert int(rounds.item()) == prounds
    assert (prounds == 0) if K == 1 else (1 <= prounds <= K)
    if ref_rounds is not None:
        assert int(ref_rounds.item()) == prounds
    as_i16 = (_variants.pair_to_i16(out) if store == "pair"
              else out.to(torch.int16))
    assert torch.equal(as_i16, ref)
    return prounds


@pytest.mark.parametrize("K", [1, 2, 7, 23])
@pytest.mark.parametrize("L", [1, 3, 33, 129, 8191])
@pytest.mark.parametrize("load,store", VARIANTS)
def test_variant_kernel_chunks_match_plains(dev, load, store, L, K):
    """Forced K over B = 23 (prime: a short last chunk unless K is 1 or 23)
    at ragged lane counts; with L = 33 or 129 and K > 1 a warp's items
    straddle two chunks, and L = 1 or 3 leaves a u8 row's word shared with
    the next row's bytes."""
    blocks_t, state = _lanes(8, 23, L, seed=L * 10 + K, dev=dev)
    _variant_chunked_equals_plains(load, store, blocks_t, state, K)


@pytest.mark.parametrize("load,store", VARIANTS)
def test_variant_kernel_slow_merging_stream(dev, load, store):
    """K = B: the starts take more than two rounds to settle."""
    prof, words, state = _words_case(8, 23, 33, 5, dev, slow=True)
    from bjxa_tpu_torch.ops.decode import words_to_blocks

    blocks_t = words_to_blocks(prof, words, bits=8).contiguous()
    assert 2 < _variant_chunked_equals_plains(load, store, blocks_t, state,
                                              23) <= 23


@pytest.mark.parametrize("load,store", VARIANTS)
@pytest.mark.parametrize("B,L,K", [
    (0, 5, 4),  # no blocks: end = state, no round
    (300, 8191, 37),  # more work items than the persistent grid's threads
    (512, 32, None),  # the wrapper's own K at corpus chunking (64, Bc = 8)
    (64, 32768, None),  # the scripts' shape: K = 1
])
def test_variant_kernel_shapes_match_plains(dev, load, store, B, L, K):
    blocks_t, state = _lanes(8, B, L, seed=B + L, dev=dev)
    if K is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        K = cuda_decode_words.pick_word_chunks(B, L, sms)
    _variant_chunked_equals_plains(load, store, blocks_t, state, K)


def test_variant_kernel_refused_launch_raises(dev, monkeypatch):
    """A cooperative grid larger than the card holds at once is refused,
    and the wrapper raises; nothing falls back."""
    blocks_t, state = _lanes(8, 64, 4096, seed=3, dev=dev)
    for load, store in VARIANTS:
        fit = cuda_decode.grid_ctas(1 << 40, "bjxa_decode_variant_occupancy",
                                    _variants.LOADS[load],
                                    _variants.STORES[store][0], device=dev)
        monkeypatch.setattr(_variants, "grid_ctas",
                            lambda *a, fit=fit, **k: fit + 1)
        before = (load_variants.LAUNCHES, store_variants.LAUNCHES)
        with pytest.raises(RuntimeError, match="bjxa_decode_variant"):
            if load == "w32":
                prof, words = (torch.from_numpy(a).to(dev) for a in
                               words_from_blocks_host(blocks_t.cpu().numpy(),
                                                      8))
                load_variants.decode_w32_chunked(prof, words, state,
                                                 store=store, chunks=4)
            else:
                store_variants.decode_variant_chunked(blocks_t, state,
                                                      mode=store, chunks=4)
        assert (load_variants.LAUNCHES, store_variants.LAUNCHES) == before


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("store", ["i16", "i32", "pair"])
def test_u8_variant_takes_unaligned_blocks(dev, store, offset):
    """Blocks that start off a 16-byte boundary (a view into a larger
    buffer) decode as the aligned copy does, at K = 1 and chunked."""
    blocks_t, state = _lanes(8, 23, 129, seed=offset, dev=dev)
    flat = torch.empty(blocks_t.numel() + offset, dtype=torch.uint8,
                       device=dev)
    shifted = flat[offset:].view(blocks_t.shape)
    shifted.copy_(blocks_t)
    assert shifted.data_ptr() % 16
    for K in (1, 7):
        _variant_chunked_equals_plains("u8", store, shifted, state, K)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129), (300, 3), (0, 7),
                                 (23, 1), (23, 33), (7, 8191),
                                 (64, 32768)])
def test_loadstore_bound_kernel_matches_plain(dev, bits, B, L):
    rng = np.random.default_rng(bits * B + L)
    prof = torch.from_numpy(
        rng.integers(0, 256, size=(B, L), dtype=np.uint8)).to(dev)
    words = rng.integers(-(2**31), 2**31, size=(B, bits, L), dtype=np.int64)
    words[:, :, 0] = 2**31 - 1  # sums that wrap
    words = torch.from_numpy(words.astype(np.int32)).to(dev)
    state = torch.from_numpy(
        rng.integers(-(2**31), 2**31, size=(L, 2), dtype=np.int64)
        .astype(np.int32)).to(dev)
    before = roofline_bound.LAUNCHES
    out, end = roofline_bound.null_decode(prof, words, state)
    assert roofline_bound.LAUNCHES == before + 1
    pout, pend = roofline_bound.null_decode_plain(prof, words, state)
    torch.cuda.synchronize()
    assert out.dtype == pout.dtype and torch.equal(out, pout)
    assert end.dtype == pend.dtype and torch.equal(end, pend)


#: The ALU probe's card cases, (dtype, shape, offset in elements): a ragged
#: 2-D shape, the scripts' shape (None), odd and tiny counts, and views
#: 1-7 int16 or 1-3 int32 elements past a 16-byte boundary.
ALU_CASES = [
    (dtype, shape, offset)
    for dtype in (torch.int32, torch.int16)
    for shape, offset in [((37, 129), 0), (None, 0), ((7, 8191), 0),
                          ((1,), 0), ((3,), 0), ((2047,), 0)]
    + [((4099,), k) for k in range(1, 16 // dtype.itemsize)]
]


@pytest.mark.parametrize("dtype,shape,offset", ALU_CASES, ids=str)
@pytest.mark.parametrize("mix", ["full", "clip", "muladd"])
def test_alu_mix_kernel_matches_plain(dev, dtype, mix, shape, offset):
    shape = shape or encode_pack_falsify.SHAPE
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(len(mix) + offset)
    x = rng.integers(info.min, info.max + 1, size=int(np.prod(shape)) + offset)
    x[offset:offset + 4] = [info.max, info.min, -1, 0][:x.size - offset]
    x = torch.from_numpy(x).to(dtype).to(dev)[offset:].view(shape)
    before = encode_pack_falsify.LAUNCHES
    got = encode_pack_falsify.alu_mix(x, mix=mix)
    assert encode_pack_falsify.LAUNCHES == before + 1
    want = encode_pack_falsify.alu_mix_plain(x, mix=mix)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got.is_contiguous() and got.shape == x.shape
    assert (got.data_ptr() - x.data_ptr()) % 16 == 0


def test_alu_mix_refused_launch_raises(dev, monkeypatch):
    """A grid of no CTAs is refused by the runtime, and the wrapper raises;
    nothing falls back."""
    x = torch.arange(1000, dtype=torch.int16, device=dev)
    monkeypatch.setattr(encode_pack_falsify, "persistent_ctas",
                        lambda *a: 0)
    before = encode_pack_falsify.LAUNCHES
    with pytest.raises(RuntimeError, match="bjxa_alu_mix"):
        encode_pack_falsify.alu_mix(x, mix="full")
    assert encode_pack_falsify.LAUNCHES == before


def test_measurement_wrappers_reject_bad_inputs(dev):
    blocks_t, state = _lanes(8, 2, 8, seed=0, dev=dev)
    prof, words = words_from_blocks_host(blocks_t.cpu().numpy(), 8)
    prof, words = torch.from_numpy(prof).to(dev), torch.from_numpy(words).to(dev)
    with pytest.raises(ValueError):
        store_variants.decode_variant(blocks_t, state, mode="i8")
    with pytest.raises(ValueError):
        store_variants.decode_variant(blocks_t[:, :25].contiguous(), state,
                                      mode="i16")
    with pytest.raises(TypeError):
        store_variants.decode_variant(blocks_t, state.long(), mode="i16")
    with pytest.raises(ValueError):
        store_variants.decode_variant(blocks_t, state.cpu(), mode="i16")
    with pytest.raises(ValueError):
        load_variants.decode_w32(prof, words, state, store="i32")
    with pytest.raises(ValueError):
        load_variants.decode_w32(prof[:1], words, state, store="i16")
    with pytest.raises(TypeError):
        load_variants.decode_w32(prof, words.long(), state, store="pair")
    with pytest.raises(ValueError):
        roofline_bound.null_decode(prof, words[:, :5].contiguous(), state)
    with pytest.raises(TypeError):
        roofline_bound.null_decode(prof.int(), words, state)
    with pytest.raises(ValueError):
        roofline_bound.null_decode(prof, words, state[:4])
    x = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        encode_pack_falsify.alu_mix(x, mix="fma")
    with pytest.raises(TypeError):
        encode_pack_falsify.alu_mix(x.long(), mix="full")
    with pytest.raises(ValueError):
        encode_pack_falsify.alu_mix(x.t(), mix="full")


# -- the segmented path -------------------------------------------------------


@pytest.mark.parametrize("bits,channels,blocks,seg", [
    (6, 2, 5000, 1024), (4, 1, 777, 100), (8, 2, 300, 7),
])
def test_segmented_decode_card_matches_whole_file(dev, bits, channels,
                                                  blocks, seg):
    data = _xa(bits, channels, blocks, seed=blocks + seg)
    fmt = parse_xa_header(data)
    before = cuda_decode.STREAM_LAUNCHES + cuda_filter.SHORT_LAUNCHES
    stream_before = cuda_decode.STREAM_LAUNCHES
    parts = list(iter_decode_segments(io.BytesIO(data[32:]).read, fmt,
                                      device=dev, segment_blocks=seg))
    assert cuda_decode.STREAM_LAUNCHES + cuda_filter.SHORT_LAUNCHES > before
    assert len(parts) == -(-blocks // seg)
    if seg > 64:  # every segment is long: one stream launch each
        assert cuda_decode.STREAM_LAUNCHES - stream_before == len(parts)
    np.testing.assert_array_equal(
        np.concatenate(parts), decode_bytes(data[32:], fmt, device="cpu"))
    out = io.BytesIO()
    decode_xa_stream(io.BytesIO(data), out, device=dev, segment_blocks=seg)
    assert out.getvalue() == xa_to_wav(data, device=dev)


def test_segmented_decode_card_failures_match_cpu(dev):
    data = bytearray(_xa(6, 2, 900, seed=77))
    data[32 + (500 * 2 + 1) * 25] = 0xF0
    fmt = parse_xa_header(bytes(data))
    for payload in (bytes(data[32:]), bytes(data[32: 32 + 333 * 50 + 9])):
        runs = []
        for d in (dev, "cpu"):
            parts, raised = [], None
            try:
                for p in iter_decode_segments(io.BytesIO(payload).read, fmt,
                                              device=d, segment_blocks=128):
                    parts.append(p)
            except (EOFError, BjxaProtocolError) as e:
                raised = (type(e).__name__, str(e))
            runs.append((np.concatenate(parts), raised))
        assert runs[0][1] == runs[1][1] and runs[0][1] is not None
        np.testing.assert_array_equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize("search", [True, False])
def test_segmented_encode_card_matches_whole_file(dev, search):
    wav = _wav(2, 700 * 32 - 13, seed=5)
    before = (cuda_encode.LAUNCHES, cuda_encode.FIXPOINT_LAUNCHES)
    out = io.BytesIO()
    encode_wav_stream(io.BytesIO(wav), out, 6, search=search, device=dev,
                      segment_blocks=96)
    # 8 segments, each one fixed-point launch (K = 6), none sequential
    assert (cuda_encode.LAUNCHES - before[0],
            cuda_encode.FIXPOINT_LAUNCHES - before[1]) == (0, 8 * search)
    assert out.getvalue() == wav_to_xa(wav, 6, search=search, device=dev)
    assert out.getvalue() == wav_to_xa(wav, 6, search=search, device="cpu")


def test_corpus_oversized_files_card_match_cpu(dev, tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "big.xa").write_bytes(_xa(6, 2, 3000, seed=1))
    (src / "small.xa").write_bytes(_xa(6, 2, 30, seed=2))
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "100000")
    before = (cuda_decode.STREAM_LAUNCHES, cuda_decode.LAUNCHES)
    card = decode_corpus(src, tmp_path / "card", device=dev)
    # the segmented route's kernel, and never the lanes kernel
    assert cuda_decode.STREAM_LAUNCHES > before[0]
    assert cuda_decode.LAUNCHES == before[1]
    cpu = decode_corpus(src, tmp_path / "cpu", device="cpu")
    assert card.converted == cpu.converted == 2 and not card.failed
    assert "segmented" in card.counters.stage_ms
    for p in sorted((tmp_path / "cpu").glob("*.wav")):
        assert (tmp_path / "card" / p.name).read_bytes() == p.read_bytes()


# ---------------------------------------------------------------------------
# the streaming codec's device search and the channel-major wrappers


def _codec_pcm(frames, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None]
    sig = 12000 * np.sin(t / (6.0 + np.arange(channels)))
    sig += rng.normal(0, 3000, size=(frames, channels))
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_encoder_device_search_matches_cpu_and_native(dev, monkeypatch, bits,
                                                      channels):
    """The codec's search without the native library: kernel 7 on the
    card, one launch a call, the carried state across calls; the same
    bytes as its plain version on the CPU and as the native library."""
    from bjxa_tpu_torch import RiffFormat, codec, native

    pcm = _codec_pcm(32 * 50 + 11, channels, seed=bits + channels)
    riff = RiffFormat(pcm.size * 2, 44100, channels)
    cuts = [0, 32 * 7, 32 * 20, 32 * 21, len(pcm)]

    def run(device):
        enc = codec.Encoder(device=device)
        enc.init(riff, bits)
        return enc.dump_header() + b"".join(
            enc.encode(pcm[a:b], search=True)
            for a, b in zip(cuts, cuts[1:]))

    want_native = run(None)  # the native library is on
    monkeypatch.setattr(native, "available", lambda: False)
    before = cuda_encode.LAUNCHES
    card = run(None)
    assert cuda_encode.LAUNCHES - before == len(cuts) - 1
    before = cuda_encode.LAUNCHES
    cpu = run("cpu")
    assert cuda_encode.LAUNCHES == before
    assert card == cpu == want_native


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_decode_arrays_fixpoint_card_matches_cpu(dev, bits, channels):
    """On the card the wrapper runs the lanes kernel, rounds + 1 launches,
    and gives the CPU's frames, end state, validity and rounds."""
    from bjxa_tpu_torch.ops import decode_arrays_fixpoint

    rng = np.random.default_rng(bits * 3 + channels)
    B = 1009
    raw = rng.integers(0, 256, size=(channels, B, 4 * bits + 1),
                       dtype=np.uint8)
    raw[..., 0] = (rng.integers(0, 5, size=(channels, B)) << 4
                   | rng.integers(0, 13, size=(channels, B)))
    raw[channels - 1, 500, 0] = 0x7B
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    b, s = torch.from_numpy(raw), torch.from_numpy(state)
    before = cuda_decode.LAUNCHES
    got = decode_arrays_fixpoint(b.to(dev), s.to(dev), bits=bits,
                                 num_chunks=16)
    assert cuda_decode.LAUNCHES - before == got[3] + 1
    want = decode_arrays_fixpoint(b, s, bits=bits, num_chunks=16)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    assert got[3] == want[3]


def test_decode_batch_card_matches_cpu(dev):
    """One launch of the filter kernel decodes the batch as the CPU does."""
    from bjxa_tpu_torch.ops import decode_batch

    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, size=(32, 2, 40, 33), dtype=np.uint8)
    raw[..., 0] = (rng.integers(0, 5, size=(32, 2, 40)) << 4
                   | rng.integers(0, 13, size=(32, 2, 40)))
    state = rng.integers(-(2**15), 2**15, size=(32, 2, 2)).astype(np.int32)
    b, s = torch.from_numpy(raw), torch.from_numpy(state)
    before = cuda_filter.LAUNCHES
    got = decode_batch(b.to(dev), s.to(dev), bits=8)
    assert cuda_filter.LAUNCHES - before == 1
    for g, w in zip(got, decode_batch(b, s, bits=8)):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# the scaling layer on meshes that name the card more than once
# ---------------------------------------------------------------------------


def _mesh(dev, n, axis_names):
    from bjxa_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device(dev.type, dev.index or 0)] * n, dp=n,
                     sp=1, axis_names=axis_names)


@pytest.mark.parametrize("bits,channels,blocks", [(6, 2, 3001), (4, 1, 517)])
def test_sp_ring_decode_card_matches_cpu(dev, bits, channels, blocks):
    """The ring decode on ``[cuda:0] * 4``: the lanes kernel states-only in
    every round, with output in the final pass; PCM, validity and rounds
    equal the same ring on the CPU and the single-device decode."""
    from bjxa_tpu_torch.parallel.sharded import decode_file_sharded

    rng = np.random.default_rng(blocks)
    blocks_c = rng.integers(0, 256, size=(channels, blocks, 4 * bits + 1),
                            dtype=np.uint8)
    blocks_c[:, :, 0] = (rng.integers(0, 5, size=(channels, blocks)) << 4
                         | rng.integers(0, 13, size=(channels, blocks)))
    blocks_c[0, blocks // 3, 0] = 0x70
    state = rng.integers(-900, 900, size=(channels, 2)).astype(np.int32)
    before = cuda_decode.LAUNCHES
    got = decode_file_sharded(blocks_c, state, bits=bits,
                              mesh=_mesh(dev, 4, ("sp", "_")), axis="sp")
    launches = cuda_decode.LAUNCHES - before
    cpu = decode_file_sharded(blocks_c, state, bits=bits,
                              mesh=_mesh(torch.device("cpu"), 4, ("sp", "_")),
                              axis="sp")
    np.testing.assert_array_equal(got[0], cpu[0])
    np.testing.assert_array_equal(got[1], cpu[1])
    assert got[2] == cpu[2] and not got[1].all()
    assert launches > 4 * (got[2] + 1)  # every round, every shard, a launch
    from bjxa_tpu_torch.ops.decode import decode_arrays

    one, _end, valid = decode_arrays(
        torch.from_numpy(blocks_c), torch.from_numpy(state), bits=bits)
    np.testing.assert_array_equal(got[0], one.numpy())
    np.testing.assert_array_equal(got[1], valid.numpy())


def test_sp_ring_encode_card_matches_single_device(dev):
    """The ring encode on ``[cuda:0] * 4`` (kernel 7 in every round): the
    bytes and end state of the single-device search on the card."""
    from bjxa_tpu_torch.ops.encode import encode_search
    from bjxa_tpu_torch.ops.deflate import deflate_blocks
    from bjxa_tpu_torch.parallel.sharded import encode_file_sharded

    rng = np.random.default_rng(9)
    B, C = 700, 2
    t = np.arange(B * 32)[:, None]
    pcm = (9000 * np.sin(t / (23.0 + 5 * np.arange(C)))
           + rng.normal(0, 900, (B * 32, C))).astype(np.int16)
    pcm = pcm.reshape(B, 32, C)
    before = cuda_encode.LAUNCHES
    blocks, end, rounds = encode_file_sharded(
        pcm, np.zeros((C, 2), np.int32), bits=6,
        mesh=_mesh(dev, 4, ("sp", "_")), b_total=B - 3)
    assert cuda_encode.LAUNCHES - before > 4 * rounds
    prof, coded, recon, _ = encode_search(
        torch.from_numpy(pcm[: B - 3]).to(dev),
        torch.zeros((C, 2), dtype=torch.int32, device=dev), bits=6)
    want = deflate_blocks(prof, coded.transpose(1, 2), 6).cpu().numpy()
    np.testing.assert_array_equal(blocks, want)
    r = recon[-1].cpu().numpy()
    np.testing.assert_array_equal(end, np.stack([r[-1], r[-2]], -1))


def test_dp_words_decode_card_matches_single_device(dev):
    """The words decode sharded over ``[cuda:0] * 4``: one words-kernel
    launch a shard, reassembled to the single-device batch decode."""
    from bjxa_tpu_torch.ops.decode import decode_batch_words
    from bjxa_tpu_torch.parallel.sharded import (
        decode_corpus_sharded_words,
        host_flat,
    )

    blocks_t, state = _lanes(8, 300, 37, seed=3, dev=torch.device("cpu"))
    prof, words = words_from_blocks_host(blocks_t.numpy(), 8)
    before = cuda_decode_words.LAUNCHES
    shards, reassemble = decode_corpus_sharded_words(
        prof, words, state.numpy(), bits=8, mesh=_mesh(dev, 4, ("dp", "sp")))
    assert cuda_decode_words.LAUNCHES - before == 4
    assert all(s.device.type == "cuda" for s in shards)
    pcm, _end, _valid = decode_batch_words(
        torch.from_numpy(prof).to(dev), torch.from_numpy(words).to(dev),
        state.to(dev), bits=8)
    np.testing.assert_array_equal(reassemble(host_flat(shards)),
                                  pcm.cpu().numpy())
