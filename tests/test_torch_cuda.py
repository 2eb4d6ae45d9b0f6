"""The CUDA kernels on the card against their plain PyTorch versions, and
the whole-file decode and encode on the card against the CPU.  Exact
comparison.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

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
from bjxa_tpu_torch.ops import cuda_decode, cuda_encode, cuda_filter
from bjxa_tpu_torch.ops.decode import decode_bytes
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


@pytest.mark.parametrize("B,L", [(13, 1), (64, 2), (20, 300)])
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
    data = _xa(bits, channels, blocks, seed=blocks)
    fmt = parse_xa_header(data)
    counter = cuda_decode if kernel == "decode" else cuda_filter
    before = counter.LAUNCHES
    got = decode_bytes(data[32:], fmt, device=dev)
    assert counter.LAUNCHES > before
    np.testing.assert_array_equal(
        got, decode_bytes(data[32:], fmt, device="cpu")
    )


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,L", [(3, 37), (64, 1), (1, 2), (5, 130)])
def test_encode_kernel_matches_plain(dev, bits, B, L):
    rng = np.random.default_rng(bits * 1000 + B * L)
    pcm = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(B, 32, L)).astype(np.int16)
    ).to(dev)
    state = torch.from_numpy(
        rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    ).to(dev)
    before = cuda_encode.LAUNCHES
    got = cuda_encode.encode_search_lanes(pcm, state, bits=bits)
    assert cuda_encode.LAUNCHES == before + 1
    want = cuda_encode.encode_search_lanes_plain(pcm, state, bits=bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


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
