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
    """A fixpoint-length stream (the kernel runs once per round) and a
    short one (the sequential search), search and truncation."""
    for frames in (300 * 32 + 7, 23 * 32 - 5):
        wav = _wav(channels, frames, seed=bits * channels + frames)
        before = cuda_encode.LAUNCHES
        got = wav_to_xa(wav, bits, device=dev)
        assert cuda_encode.LAUNCHES > before
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
        before = cuda_encode.LAUNCHES
        card = encode_corpus(src, tmp_path / f"card{search}", device=dev,
                             search=search, batch_files=2,
                             bucket_granularity=16)
        assert (cuda_encode.LAUNCHES > before) == search
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


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(40, 1000), (3, 129), (300, 3)])
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("mix", ["full", "clip", "muladd"])
def test_alu_mix_kernel_matches_plain(dev, dtype, mix):
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(len(mix))
    x = rng.integers(info.min, info.max + 1, size=(37, 129))
    x[0, :4] = [info.max, info.min, -1, 0]
    x = torch.from_numpy(x).to(dtype).to(dev)
    before = encode_pack_falsify.LAUNCHES
    got = encode_pack_falsify.alu_mix(x, mix=mix)
    assert encode_pack_falsify.LAUNCHES == before + 1
    want = encode_pack_falsify.alu_mix_plain(x, mix=mix)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


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
    before = cuda_encode.LAUNCHES
    out = io.BytesIO()
    encode_wav_stream(io.BytesIO(wav), out, 6, search=search, device=dev,
                      segment_blocks=96)
    assert (cuda_encode.LAUNCHES > before) == search
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
