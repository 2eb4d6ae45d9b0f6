"""The chunked schedule of the words kernel against the sequential decode
and the JAX package, on the CPU.  Exact comparison: PCM and end state must
be equal bit for bit, tolerance 0.

``fused_decode_words_chunked_plain`` runs the kernel's schedule in plain
PyTorch: each lane's blocks cut into K chunks (the last one short where K
does not divide B), the chunks' starts solved by the exact fixed point,
then one pass with output.  It is held against the sequential plain decode
and against the TPU words kernel (``bjxa_tpu.ops.pallas_decode``, interpret
mode, at the tile shape of ``tests/test_torch_words.py``); the kernel is
held against it, rounds included, on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops.pallas_decode import fused_decode_words_padded
from bjxa_tpu.ops.tables import BLOCK_SAMPLES
from bjxa_tpu_torch.ops import cuda_decode_words as cdw
from bjxa_tpu_torch.ops import decode as tdecode

B_PRIME = 23  # prime, so every K but 1 and B leaves a short last chunk


def _random(bits, B, L, seed):
    """Random payload, profile factors 0-7 (5-7 invalid) in mid-stream,
    int16-range entry states."""
    rng = np.random.default_rng(seed)
    blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L),
                            dtype=np.uint8)
    blocks_t[:, 0, :] = (rng.integers(0, 8, size=(B, L)) << 4
                         | rng.integers(0, 16, size=(B, L))).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return blocks_t, state


def _slow_merging(bits, B, L, seed):
    """Factor 4 (the filter that forgets slowest), range 12 and payload
    bytes near zero (tiny residuals), int16-range entry states: chunk
    starts that begin wrong stay wrong for many blocks."""
    rng = np.random.default_rng(seed)
    blocks_t = np.zeros((B, 4 * bits + 1, L), np.uint8)
    blocks_t[:, 1:, :] = rng.choice(
        np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8), size=(B, 4 * bits, L)
    )
    blocks_t[:, 0, :] = 4 << 4 | 12
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return blocks_t, state


def _words(blocks_t, state, bits):
    prof, words = tdecode.words_from_blocks_host(blocks_t, bits)
    return tuple(torch.from_numpy(a) for a in (prof, words, state))


@functools.cache
def _jax(kind, bits, B, L, seed):
    """The TPU words kernel in interpret mode (lane tile 256, block tile 4,
    16 sublanes, padded), trimmed to ``[B, 32, L]``."""
    blocks_t, state = kind(bits, B, L, seed)
    prof, words = tdecode.words_from_blocks_host(blocks_t, bits)
    pcm, end = fused_decode_words_padded(
        jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state), bits=bits,
        lane_tile=256, block_tile=4, sublanes=16, interpret=True,
    )
    Bp = pcm.shape[0]
    pcm = np.asarray(pcm).reshape(Bp, BLOCK_SAMPLES, -1)[:B, :, :L]
    return pcm, np.asarray(end)


def _check(kind, bits, B, L, K, seed):
    """Chunked plain == sequential plain == JAX, with and without output.
    Returns the round count."""
    prof, words, state = _words(*kind(bits, B, L, seed), bits)
    seq_pcm, seq_end = cdw.fused_decode_words_plain(prof, words, state,
                                                    bits=bits)
    pcm, end, rounds = cdw.fused_decode_words_chunked_plain(
        prof, words, state, bits=bits, chunks=K
    )
    jpcm, jend = _jax(kind, bits, B, L, seed)
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (B, 32, L)
    assert end.dtype == torch.int32 and tuple(end.shape) == (L, 2)
    np.testing.assert_array_equal(pcm.numpy(), seq_pcm.numpy())
    np.testing.assert_array_equal(end.numpy(), seq_end.numpy())
    np.testing.assert_array_equal(pcm.numpy(), jpcm)
    np.testing.assert_array_equal(end.numpy(), jend)
    none, s_end, s_rounds = cdw.fused_decode_words_chunked_plain(
        prof, words, state, bits=bits, chunks=K, with_output=False
    )
    assert none is None and s_rounds == rounds
    np.testing.assert_array_equal(s_end.numpy(), jend)
    K_eff, _Bc = cdw.word_chunks(B, K)
    assert (rounds == 0) if K_eff == 1 else (1 <= rounds <= K_eff)
    return rounds


@pytest.mark.parametrize("K", [1, 3, 7, B_PRIME])
@pytest.mark.parametrize("L", [1, 2, 32, 33])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_chunked_matches_sequential_and_jax(bits, L, K):
    """Ragged chunks (B = 23), invalid profiles in mid-stream and
    int16-range entry states."""
    _check(_random, bits, B_PRIME, L, K, seed=bits * 100 + L)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_slow_merging_stream_stays_exact(bits):
    """K = B (one block a chunk): the starts take more than two rounds to
    settle, at most K, and the result is exact all the same."""
    rounds = _check(_slow_merging, bits, B_PRIME, 33, B_PRIME, seed=bits)
    assert 2 < rounds <= B_PRIME


@pytest.mark.parametrize("bits", [4, 8])
def test_chunked_no_blocks(bits):
    prof, words, state = _words(*_random(bits, 0, 5, seed=3), bits)
    pcm, end, rounds = cdw.fused_decode_words_chunked_plain(
        prof, words, state, bits=bits, chunks=4
    )
    assert tuple(pcm.shape) == (0, 32, 5) and rounds == 0
    assert torch.equal(end, state)


@pytest.mark.parametrize("B,chunks,want", [
    (23, 1, (1, 23)), (23, 3, (3, 8)), (23, 7, (6, 4)), (23, 23, (23, 1)),
    (23, 50, (23, 1)), (24, 7, (6, 4)), (1, 5, (1, 1)), (0, 9, (1, 0)),
    (20736, 2592, (2592, 8)), (20736, 1000, (988, 21)),
])
def test_word_chunks_leave_no_empty_chunk(B, chunks, want):
    K, Bc = cdw.word_chunks(B, chunks)
    assert (K, Bc) == want
    if B:
        assert K * Bc >= B > (K - 1) * Bc  # the last chunk holds a block


def test_word_chunks_rejects_zero():
    with pytest.raises(ValueError):
        cdw.word_chunks(10, 0)


@pytest.mark.parametrize("B,L,sms,want", [
    (64, 32768, 132, 1),  # the bench.py headline: lanes fill the card
    (64, 16896, 132, 1),  # exactly one CTA of lanes an SM
    (20736, 32, 132, 1296),  # a corpus batch of 16 stereo files
    (20736, 128, 132, 330),  # 64 stereo files, the CLI's default batch
    (512, 32, 132, 64),  # short files: 8 blocks a chunk at the least
    (15, 32, 132, 1),  # too short for two chunks of 8 blocks
    (0, 32, 132, 1),
    (64, 0, 132, 1),  # no lanes
])
def test_pick_word_chunks(B, L, sms, want):
    K = cdw.pick_word_chunks(B, L, sms)
    assert K == want
    K_eff, Bc = cdw.word_chunks(B, K)
    assert K_eff == K
    if K > 1:
        assert Bc >= tdecode.MIN_CHUNK_BLOCKS


def test_chunked_plain_matches_at_corpus_chunking():
    """The corpus batch's chunk geometry at a smaller block count: Bc = 8
    blocks a chunk over 32 lanes, every profile valid."""
    bits, B, L = 8, 8 * 37, 32
    prof, words, state = _words(*_random(bits, B, L, seed=5), bits)
    prof = prof % 80  # factors 0-4 only, as in a corpus of valid files
    K = cdw.pick_word_chunks(B, L, sm_count=132)
    assert cdw.word_chunks(B, K) == (37, 8)
    pcm, end, rounds = cdw.fused_decode_words_chunked_plain(
        prof, words, state, bits=bits, chunks=K
    )
    want_pcm, want_end = cdw.fused_decode_words_plain(prof, words, state,
                                                      bits=bits)
    assert torch.equal(pcm, want_pcm) and torch.equal(end, want_end)
    assert 1 <= rounds <= K
