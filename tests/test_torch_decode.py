"""Whole-file decode of the PyTorch port (on the CPU) against
:mod:`bjxa_tpu.ops.decode` and the in-repo known answer.

Block counts cover the short path (1, 13, 17, 23, 61: no chunk count
divides them), exact chunking (64), bucket padding (200, 1000) and a
mid-stream invalid profile.  PCM, end states, validity, iteration counts
and error messages must be identical.
"""

import hashlib
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.errors import BjxaProtocolError as JaxProtocolError
from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu_torch import XAFormat, dump_xa_header, parse_xa_header, xa_to_wav
from bjxa_tpu_torch.errors import BjxaProtocolError
from bjxa_tpu_torch.format.hexdsl import hex_to_bytes
from bjxa_tpu_torch.ops import decode as tdecode
from test_golden_decode import SATURATION_WAV_SHA1, SATURATION_XA


def make_xa(bits, channels, blocks, seed, bad_block=None):
    """A valid XA file image from a seed: random payload bytes, valid
    profiles, a nonzero initial state; ``bad_block`` gets an invalid
    profile factor in its last channel."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(blocks, channels)) << 4
        | rng.integers(0, 13, size=(blocks, channels))
    ).astype(np.uint8)
    if bad_block is not None:
        raw[bad_block, channels - 1, 0] = 0x53
    fmt = XAFormat(
        data_len=raw.size, samples=blocks * 32 - int(rng.integers(0, 32)),
        samples_rate=22050, bits=bits, channels=channels,
        initial_state=((0, 0), (0, 0)),
    )
    hdr = bytearray(dump_xa_header(fmt))
    struct.pack_into(
        "<4h", hdr, 20, *rng.integers(-(2**15), 2**15, 4).tolist()
    )
    return bytes(hdr) + raw.tobytes()


CASES = [  # (bits, channels, blocks)
    (4, 1, 1), (6, 2, 13), (8, 1, 17), (6, 1, 23), (4, 2, 61),
    (8, 2, 64), (6, 2, 200), (4, 1, 1000),
]


@pytest.mark.parametrize("bits,channels,blocks", CASES)
def test_decode_bytes_matches_jax(bits, channels, blocks):
    data = make_xa(bits, channels, blocks, seed=blocks)
    fmt = parse_xa_header(data)
    payload = data[32:]
    got = tdecode.decode_bytes(payload, fmt, device="cpu")
    want = jdecode.decode_bytes(payload, fmt)
    assert got.dtype == np.int16 and got.shape == (fmt.samples, channels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,channels,blocks", [(6, 2, 200), (4, 1, 1000),
                                                  (8, 2, 64)])
def test_fixpoint_lanes_matches_jax(bits, channels, blocks):
    """Same staging, same chunk count, same converged output, end state
    and iteration count."""
    data = make_xa(bits, channels, blocks, seed=3 * blocks)
    fmt = parse_xa_header(data)
    Bp = tdecode.pad_bucket(blocks)
    assert Bp == jdecode.pad_bucket(blocks)
    K = tdecode.pick_chunks(Bp, channels)
    assert K > 1
    blocks_t = tdecode.chunk_lanes_from_bytes(data[32:], fmt, K, Bp)
    np.testing.assert_array_equal(
        blocks_t, jdecode.chunk_lanes_from_bytes(data[32:], fmt, K, Bp)
    )
    state = fmt.initial_state_array()
    kw = dict(bits=bits, num_chunks=K, channels=channels, b_total=blocks)
    tf, te, tv, ti = tdecode.decode_fixpoint_lanes(
        torch.from_numpy(blocks_t), torch.from_numpy(state), **kw
    )
    jf, je, jv, ji = jdecode.decode_fixpoint_lanes(
        jnp.asarray(blocks_t), jnp.asarray(state), **kw
    )
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti == int(ji)


def test_decode_arrays_matches_jax():
    data = make_xa(8, 2, 9, seed=4)
    fmt = parse_xa_header(data)
    blocks = tdecode.blocks_from_bytes(data[32:], fmt)
    np.testing.assert_array_equal(
        blocks, jdecode.blocks_from_bytes(data[32:], fmt)
    )
    state = fmt.initial_state_array()
    got = tdecode.decode_arrays(
        torch.from_numpy(blocks), torch.from_numpy(state), bits=8
    )
    want = jdecode.decode_arrays(
        jnp.asarray(blocks), jnp.asarray(state), bits=8
    )
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("blocks,bad", [(23, 11), (200, 150)])
def test_invalid_profile_matches_jax(blocks, bad):
    data = make_xa(6, 2, blocks, seed=blocks, bad_block=bad)
    fmt = parse_xa_header(data)
    with pytest.raises(BjxaProtocolError) as got:
        tdecode.decode_bytes(data[32:], fmt, device="cpu")
    with pytest.raises(JaxProtocolError) as want:
        jdecode.decode_bytes(data[32:], fmt)
    assert str(got.value) == str(want.value)
    assert f"block {bad} channel 1" in str(got.value)
    tf, tv = tdecode.decode_bytes_validity(data[32:], fmt, device="cpu")
    jf, jv = jdecode.decode_bytes_validity(data[32:], fmt)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tf[: bad * 32].numpy(), np.asarray(jf)[: bad * 32]
    )


def test_saturation_vector_sha1():
    wav = xa_to_wav(hex_to_bytes(SATURATION_XA), device="cpu")
    assert hashlib.sha1(wav).hexdigest() == SATURATION_WAV_SHA1


@pytest.mark.parametrize("Bp,C", [(1, 1), (17, 2), (61, 1), (64, 2),
                                  (256, 2), (1024, 1), (425984, 2)])
def test_chunk_count_matches_jax_choice(Bp, C):
    """pick_chunks is the loop inlined in the JAX decode_bytes_validity."""
    K = min(4096, max(1, 8192 // C), max(1, Bp // 8))
    while Bp % K:
        K -= 1
    assert tdecode.pick_chunks(Bp, C) == K
