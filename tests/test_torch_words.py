"""The packed-words layout and the batch decoders of the PyTorch port against
:mod:`bjxa_tpu`, on the CPU.  Exact comparison: the codec is integer, so
every byte, sample, state and validity bit must be equal.

The words kernel's plain version is held against the JAX package's Pallas
words kernel in interpret mode and against its batch decoders (the scan
path on the CPU); the kernel itself is compared with the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu.ops.pallas_decode import fused_decode_words as pallas_words
from bjxa_tpu.ops.tables import BLOCK_SAMPLES
from bjxa_tpu_torch.ops import cuda_decode_words
from bjxa_tpu_torch.ops import decode as tdecode


def _mk_lanes(bits, B, L, seed=0, max_factor=5):
    """Raw lane-major blocks (profile factors below ``max_factor``; 5 and
    up are invalid) and int16-range states, as tests/test_words_path.py
    makes them."""
    rng = np.random.default_rng(seed)
    S = 4 * bits + 1
    blocks_t = rng.integers(0, 256, size=(B, S, L), dtype=np.uint8)
    factor = rng.integers(0, max_factor, size=(B, L))
    shift = rng.integers(0, 16, size=(B, L))
    blocks_t[:, 0, :] = (factor << 4 | shift).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return blocks_t, state


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(6, 16), (3, 1), (1, 37)])
def test_words_layout_matches(bits, B, L):
    """Host staging, device packing and its inverse give the JAX package's
    arrays, and round-trip the raw blocks."""
    blocks_t, _ = _mk_lanes(bits, B, L, seed=bits * B + L)
    hprof, hwords = tdecode.words_from_blocks_host(blocks_t, bits)
    jprof, jwords = jdecode.words_from_blocks_host(blocks_t, bits)
    np.testing.assert_array_equal(hprof, jprof)
    np.testing.assert_array_equal(hwords, jwords)
    assert hwords.dtype == np.int32 and hwords.shape == (B, bits, L)

    prof, words = tdecode.pack_words_from_lanes(
        torch.from_numpy(blocks_t), bits=bits
    )
    jp, jw = jdecode.pack_words_from_lanes(jnp.asarray(blocks_t), bits=bits)
    assert prof.dtype == torch.uint8 and words.dtype == torch.int32
    np.testing.assert_array_equal(prof.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(words.numpy(), hwords)

    back = tdecode.words_to_blocks(prof, words, bits=bits)
    jback = jdecode.words_to_blocks(jp, jw, bits=bits)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(back.numpy(), blocks_t)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_words_plain_matches_pallas_interpret(bits):
    """The plain version against the TPU words kernel (interpret mode) at
    the tile shape tests/test_words_path.py uses."""
    B, L, sub, lt, bt = 8, 256, 16, 256, 4
    blocks_t, state = _mk_lanes(bits, B, L, seed=2)
    prof, words = tdecode.words_from_blocks_host(blocks_t, bits)
    pcm, end = cuda_decode_words.fused_decode_words(
        torch.from_numpy(prof), torch.from_numpy(words),
        torch.from_numpy(state), bits=bits,
    )
    jpcm, jend = pallas_words(
        jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state), bits=bits,
        lane_tile=lt, block_tile=bt, sublanes=sub, interpret=True,
    )
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (B, 32, L)
    np.testing.assert_array_equal(
        pcm.numpy(), np.asarray(jpcm).reshape(B, BLOCK_SAMPLES, L)
    )
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(11, 10), (7, 96), (1, 1)])
def test_decode_batch_words_matches(bits, B, L):
    """PCM, end state and validity against the JAX batch decoder, invalid
    factors included; the states-only plain run gives the same end."""
    blocks_t, state = _mk_lanes(bits, B, L, seed=4 + B, max_factor=6)
    prof, words = tdecode.words_from_blocks_host(blocks_t, bits)
    tp, tw, ts = (torch.from_numpy(a) for a in (prof, words, state))
    pcm, end, valid = tdecode.decode_batch_words(tp, tw, ts, bits=bits)
    jpcm, jend, jvalid = jdecode.decode_batch_words(
        jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state), bits=bits
    )
    jpcm = np.asarray(jpcm).reshape(-1, BLOCK_SAMPLES, L)[:B]
    np.testing.assert_array_equal(pcm.numpy(), jpcm)
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert B * L == 1 or not valid.all()  # max_factor=6: invalid ones
    none, states_end = cuda_decode_words.fused_decode_words(
        tp, tw, ts, bits=bits, with_output=False
    )
    assert none is None
    np.testing.assert_array_equal(states_end.numpy(), end.numpy())


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_batch_lanes_matches(bits):
    blocks_t, state = _mk_lanes(bits, 9, 13, seed=7, max_factor=6)
    pcm, end, valid = tdecode.decode_batch_lanes(
        torch.from_numpy(blocks_t), torch.from_numpy(state), bits=bits
    )
    jpcm, jend, jvalid = jdecode.decode_batch_lanes(
        jnp.asarray(blocks_t), jnp.asarray(state), bits=bits
    )
    for t, j in ((pcm, jpcm), (end, jend), (valid, jvalid)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _packed(blocks_t, state, bits):
    """The corpus engine's single staging buffer, built as its stager
    builds it (words | profile bytes | states)."""
    B, _S, L = blocks_t.shape
    nw, npr, nst = tdecode.packed_layout(B, L, bits)
    buf = np.zeros(nw + npr + nst, np.dtype("<i4"))
    prof, words = tdecode.words_from_blocks_host(blocks_t, bits)
    buf[:nw] = words.reshape(-1)
    buf[nw : nw + npr].view(np.uint8)[: B * L] = prof.reshape(-1)
    buf[nw + npr :] = state.reshape(-1)
    return buf


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(5, 7), (16, 4), (3, 1)])
def test_decode_batch_packed_matches(bits, B, L):
    assert tdecode.packed_layout(B, L, bits) == jdecode.packed_layout(
        B, L, bits
    )
    blocks_t, state = _mk_lanes(bits, B, L, seed=B * L + bits)
    buf = _packed(blocks_t, state, bits)
    pcm = tdecode.decode_batch_packed(
        torch.from_numpy(buf), bits=bits, blocks=B, lanes=L
    )
    jpcm = jdecode.decode_batch_packed(
        jnp.asarray(buf), bits=bits, blocks=B, lanes=L
    )
    assert pcm.dtype == torch.int16 and pcm.dim() == 1
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))
    want, _end, _v = tdecode.decode_batch_lanes(
        torch.from_numpy(blocks_t), torch.from_numpy(state), bits=bits
    )
    np.testing.assert_array_equal(pcm.reshape(B, 32, L).numpy(), want.numpy())


def test_decode_batch_packed_rejects_wrong_buffer():
    buf = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="decode_batch_packed"):
        tdecode.decode_batch_packed(buf, bits=4, blocks=2, lanes=3)
    with pytest.raises(ValueError, match="decode_batch_packed"):
        tdecode.decode_batch_packed(
            torch.zeros(sum(tdecode.packed_layout(2, 3, 4)),
                        dtype=torch.int64),
            bits=4, blocks=2, lanes=3,
        )


def test_cpu_tensors_never_launch(monkeypatch):
    monkeypatch.setattr(cuda_decode_words, "LAUNCHES", 0)
    blocks_t, state = _mk_lanes(6, 2, 3, seed=1)
    prof, words = tdecode.words_from_blocks_host(blocks_t, 6)
    for wo in (True, False):
        cuda_decode_words.fused_decode_words(
            torch.from_numpy(prof), torch.from_numpy(words),
            torch.from_numpy(state), bits=6, with_output=wo,
        )
    assert cuda_decode_words.LAUNCHES == 0


def test_no_kernel_device_raises():
    """A tensor on a device without a kernel raises; it never falls back
    to the plain version."""
    prof = torch.zeros((1, 4), dtype=torch.uint8, device="meta")
    words = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    state = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_decode_words.fused_decode_words(prof, words, state, bits=4)


@pytest.mark.parametrize("env", ["", "12345", "nope"])
def test_segment_threshold_matches(monkeypatch, env):
    from bjxa_tpu.errors import BjxaInvalidState as JInvalid
    from bjxa_tpu_torch.errors import BjxaInvalidState

    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", env)
    assert tdecode.SEGMENT_THRESHOLD == jdecode.SEGMENT_THRESHOLD
    if env == "nope":
        with pytest.raises(BjxaInvalidState) as got:
            tdecode.segment_threshold()
        with pytest.raises(JInvalid) as want:
            jdecode.segment_threshold()
        assert str(got.value) == str(want.value)
    else:
        assert tdecode.segment_threshold() == jdecode.segment_threshold()
