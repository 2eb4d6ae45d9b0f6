"""Device ops of the PyTorch port (plain versions, on the CPU) against
:mod:`bjxa_tpu.ops`: inflate, truncating division, profile gains and the
filter recurrence.  Integer ADPCM with int16 saturation, so every
comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops import filter as jfilter
from bjxa_tpu.ops import inflate as jinflate
from bjxa_tpu_torch.ops import filter as tfilter
from bjxa_tpu_torch.ops import inflate as tinflate

BITS_CHANNELS = [(b, c) for b in (4, 6, 8) for c in (1, 2)]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert str(t.dtype).split(".")[-1] == str(np.asarray(j).dtype)


def _blocks(rng, bits, channels, B, invalid=True):
    """``uint8[C, B, S]`` random blocks; profile factors 0-7 when
    ``invalid`` (>= 5 is invalid and must give the same garbage)."""
    S = 4 * bits + 1
    blocks = rng.integers(0, 256, size=(channels, B, S), dtype=np.uint8)
    hi = 8 if invalid else 5
    blocks[..., 0] = (
        rng.integers(0, hi, size=(channels, B)) << 4
        | rng.integers(0, 16, size=(channels, B))
    ).astype(np.uint8)
    return blocks


@pytest.mark.parametrize("bits,channels", BITS_CHANNELS)
def test_unpack_and_inflate_blocks(bits, channels):
    rng = np.random.default_rng(bits * 10 + channels)
    blocks = _blocks(rng, bits, channels, B=7)
    _eq(
        tinflate.unpack_payload(torch.from_numpy(blocks[..., 1:]), bits),
        jinflate.unpack_payload(jnp.asarray(blocks[..., 1:]), bits),
    )
    tp, ts = tinflate.inflate_blocks(torch.from_numpy(blocks), bits)
    jp, js = jinflate.inflate_blocks(jnp.asarray(blocks), bits)
    _eq(tp, jp)
    _eq(ts, js)


@pytest.mark.parametrize("bits,channels", BITS_CHANNELS)
def test_unpack_and_inflate_lanes(bits, channels):
    rng = np.random.default_rng(bits * 100 + channels)
    blocks_t = _blocks(rng, bits, 1, B=5 * channels)[0].reshape(
        5, channels, -1
    ).transpose(0, 2, 1).copy()  # [B, S, L=channels]
    _eq(
        tinflate.unpack_payload_lanes(
            torch.from_numpy(blocks_t[:, 1:, :].copy()), bits
        ),
        jinflate.unpack_payload_lanes(jnp.asarray(blocks_t[:, 1:, :]), bits),
    )
    tp, ts = tinflate.inflate_lanes(torch.from_numpy(blocks_t), bits)
    jp, js = jinflate.inflate_lanes(jnp.asarray(blocks_t), bits)
    _eq(tp, jp)
    _eq(ts, js)


def test_unpack_bad_bits_raises():
    with pytest.raises(ValueError):
        tinflate.unpack_payload(torch.zeros((1, 12), dtype=torch.uint8), 3)
    with pytest.raises(ValueError):
        tinflate.unpack_payload_lanes(
            torch.zeros((1, 12, 1), dtype=torch.uint8), 3
        )


def test_trunc_div_256_negative_and_edges():
    g = np.array(
        [0, 1, 255, 256, 257, -1, -255, -256, -257, -511, -512,
         32768 * 728, -32768 * 728, 2**31 - 256, -(2**31) + 256],
        dtype=np.int32,
    )
    rng = np.random.default_rng(0)
    g = np.concatenate([g, rng.integers(-(2**24), 2**24, 500, dtype=np.int32)])
    got = tfilter.trunc_div_256(torch.from_numpy(g))
    _eq(got, jfilter.trunc_div_256(jnp.asarray(g)))
    # C semantics: truncation toward zero
    np.testing.assert_array_equal(
        got.numpy(), (np.trunc(g.astype(np.float64) / 256)).astype(np.int32)
    )


def test_profile_gains_all_bytes():
    prof = np.arange(256, dtype=np.int32).reshape(16, 16)  # factors 0-15
    got = tfilter.profile_gains(torch.from_numpy(prof))
    want = jfilter.profile_gains(jnp.asarray(prof))
    for t, j in zip(got, want):
        _eq(t, j)


@pytest.mark.parametrize("bits,channels", BITS_CHANNELS)
@pytest.mark.parametrize("with_output", [True, False])
def test_decode_lanes_matches(bits, channels, with_output):
    rng = np.random.default_rng(bits + 7 * channels)
    B = 6
    blocks = _blocks(rng, bits, channels, B)
    jp, js = jinflate.inflate_blocks(jnp.asarray(blocks), bits)
    prof = np.asarray(jp).T.copy()  # [B, C]
    samp = np.asarray(js).transpose(1, 2, 0).copy()  # [B, 32, C]
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    tpcm, tend, tvalid = tfilter.decode_lanes(
        torch.from_numpy(prof), torch.from_numpy(samp),
        torch.from_numpy(state), with_output=with_output,
    )
    jpcm, jend, jvalid = jfilter.decode_lanes(
        jnp.asarray(prof), jnp.asarray(samp), jnp.asarray(state),
        with_output=with_output, use_pallas=False,
    )
    _eq(tend, jend)
    _eq(tvalid, jvalid)
    if with_output:
        _eq(tpcm, jpcm)
    else:
        assert tpcm is None and jpcm is None


@pytest.mark.parametrize("with_output", [True, False])
def test_adpcm_filter_lanes_saturates_like_jax(with_output):
    """Full-scale inputs at the highest gain drive the int16 clamp."""
    rng = np.random.default_rng(11)
    B, L = 5, 9
    ranged = rng.choice([-32768, 32767, 0, 16384], size=(B, 32, L)).astype(
        np.int32
    )
    k0 = np.full((B, L), 488, np.int32)
    k1 = np.full((B, L), -240, np.int32)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    tpcm, tend = tfilter.adpcm_filter_lanes(
        *(torch.from_numpy(a) for a in (ranged, k0, k1, state)),
        with_output=with_output,
    )
    jpcm, jend = jfilter.adpcm_filter_lanes(
        *(jnp.asarray(a) for a in (ranged, k0, k1, state)),
        with_output=with_output,
    )
    _eq(tend, jend)
    if with_output:
        _eq(tpcm, jpcm)
        assert tpcm.min() == -32768 and tpcm.max() == 32767
