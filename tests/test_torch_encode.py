"""The PyTorch port's encode path (on the CPU) against :mod:`bjxa_tpu`.

Deflate, truncation, the plain search (the twin of the CUDA kernel), the
ranking contract, the chunk-parallel fixed point, the chunk-count choice,
the routing of the kernel wrapper, and whole-file XA bytes.  Inputs are made
by numpy from a seed and go through both packages; every comparison is
exact (tolerance 0): the encoder's output is bytes and chosen profiles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu import api as japi
from bjxa_tpu.errors import BjxaError as JaxError
from bjxa_tpu.ops import deflate as jdeflate
from bjxa_tpu.ops import encode as jencode
from bjxa_tpu.ops.pallas_encode import encode_search_pallas_core
from bjxa_tpu_torch import api as tapi
from bjxa_tpu_torch import dump_riff_header, parse_xa_header, xa_to_wav
from bjxa_tpu_torch.errors import BjxaError, BjxaInvalidState
from bjxa_tpu_torch.ops import cuda_encode, deflate, encode


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, size=shape).astype(np.int16)


def _sine(B, L, seed):
    """A sine per lane plus noise, clipped to int16: blocks whose best
    profiles vary with the signal, unlike noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(B * 32)[:, None]
    sig = 12000 * np.sin(2 * np.pi * t / (23.0 + np.arange(L))) + rng.normal(
        0, 800, size=(B * 32, L)
    )
    return np.clip(sig, -32768, 32767).astype(np.int16).reshape(B, 32, L)


def _states(L, seed, scale=2**15):
    rng = np.random.default_rng(seed)
    return rng.integers(-scale, scale, size=(L, 2)).astype(np.int32)


def _assert_search_equal(got, want):
    """(profiles, coded, recon, end) of the port against JAX's; JAX's
    scan returns coded as int32, compared as int16."""
    prof, coded, recon, end = (t.numpy() for t in got)
    jprof, jcoded, jrecon, jend = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(prof, jprof)
    assert coded.dtype == np.int16 and recon.dtype == np.int16
    np.testing.assert_array_equal(coded, jcoded.astype(np.int16))
    np.testing.assert_array_equal(recon, jrecon)
    np.testing.assert_array_equal(end, jend)


# -- deflate and truncation ---------------------------------------------------


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_deflate_and_truncate_match_jax(bits):
    pcm = _noise((7, 32, 3), seed=bits)
    pcm[0, :4, 0] = [-32768, 32767, -1, 0]
    pcm[-1, -2:, -1] = [32767, -32768]
    profiles, coded = encode.encode_truncate(torch.from_numpy(pcm))
    jprofiles, jcoded = jencode.encode_truncate(jnp.asarray(pcm))
    np.testing.assert_array_equal(profiles.numpy(), np.asarray(jprofiles))
    np.testing.assert_array_equal(coded.numpy(), np.asarray(jcoded))
    samples = coded.transpose(1, 2)
    jsamples = jcoded.transpose(0, 2, 1)
    payload = deflate.pack_payload(samples, bits)
    assert payload.dtype == torch.uint8 and payload.shape[-1] == 4 * bits
    np.testing.assert_array_equal(
        payload.numpy(), np.asarray(jdeflate.pack_payload(jsamples, bits))
    )
    prof = torch.from_numpy(np.random.default_rng(1).integers(0, 80, (7, 3)))
    blocks = deflate.deflate_blocks(prof, samples, bits)
    np.testing.assert_array_equal(
        blocks.numpy(),
        np.asarray(jdeflate.deflate_blocks(jnp.asarray(prof.numpy()),
                                           jsamples, bits)),
    )


def test_pack_payload_rejects_bad_bits():
    with pytest.raises(ValueError, match="bad bit depth"):
        deflate.pack_payload(torch.zeros((1, 32), dtype=torch.int32), 5)


# -- the plain search against the JAX encoders --------------------------------


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("L", [1, 2, 37])
def test_plain_search_matches_jax_scan(bits, L):
    B = 5
    for pcm, seed in ((_noise((B, 32, L), seed=L), 1), (_sine(B, L, L), 2)):
        state = _states(L, seed=bits * 10 + seed)
        got = cuda_encode.encode_search_lanes(
            torch.from_numpy(pcm), torch.from_numpy(state), bits=bits
        )
        want = jencode.encode_search_scan(
            jnp.asarray(pcm.astype(np.int32)), jnp.asarray(state), bits=bits
        )
        _assert_search_equal(got, want)


def test_plain_search_matches_pallas_interpret():
    """The plain twin against the TPU kernel itself, in interpret mode at a
    small tile (as tests/test_pallas_encode.py runs it)."""
    B, L = 2, 16
    pcm = _sine(B, L, seed=3)
    state = _states(L, seed=4, scale=2000)
    got = cuda_encode.encode_search_lanes(
        torch.from_numpy(pcm), torch.from_numpy(state), bits=6
    )
    want = encode_search_pallas_core(
        jnp.asarray(pcm.astype(np.int32)), jnp.asarray(state), bits=6,
        lane_tile=16, block_tile=2, interpret=True,
    )
    _assert_search_equal(got, want)


# -- the ranking contract (tests/test_encode.py::test_rank_contract_*) --------


def _port_and_jax_profiles(pcm, bits=6):
    state = np.zeros((pcm.shape[-1], 2), np.int32)
    prof, *_ = encode.encode_search(
        torch.from_numpy(pcm), torch.from_numpy(state), bits=bits
    )
    jprof, *_ = jencode.encode_search_scan(
        jnp.asarray(pcm.astype(np.int32)), jnp.asarray(state), bits=bits
    )
    return prof.numpy(), np.asarray(jprof)


@pytest.mark.parametrize("case", ["exact_tie", "near_tie", "high_energy"])
def test_rank_contract(case):
    """Exact ties keep the earliest candidate (multiples of 1024 give
    profile 0x00), a constructed near-tie pins the candidate order
    (constant 1536 gives 0x01), and full-scale noise ranks identically."""
    rng = np.random.default_rng({"exact_tie": 11, "near_tie": 0,
                                 "high_energy": 13}[case])
    if case == "exact_tie":
        pcm = (rng.integers(-14, 14, size=(1, 32, 16)) * 1024).astype(np.int16)
    elif case == "near_tie":
        pcm = np.full((1, 32, 16), 1536, np.int16)
    else:
        pcm = rng.integers(-32768, 32768, size=(1, 32, 16)).astype(np.int16)
    prof, jprof = _port_and_jax_profiles(pcm)
    np.testing.assert_array_equal(prof, jprof)
    if case != "high_energy":
        want = 0 if case == "exact_tie" else 1
        assert prof.reshape(-1).tolist() == [want] * 16


# -- the search kernel's two-level reduction (csrc/encode_search.cu) ----------


def _two_level_choice(err, by_range=False):
    """The kernel's choice in plain torch, from ``err float32[80, L]``
    (row = profile = factor*16 + range): each range's warp keeps the first
    strict minimum over its factors, then the 16 winners are reduced in
    range order by the lexicographic ``(err, profile)`` minimum, or, with
    ``by_range``, by the first minimum in range order."""
    L = err.shape[1]
    per = err.reshape(5, 16, L)  # [factor, range, lane]
    best_e, best_p = per[0], torch.arange(16)[:, None].repeat(1, L)
    for f in range(1, 5):
        take = per[f] < best_e
        best_e = torch.where(take, per[f], best_e)
        best_p = torch.where(take, f * 16 + torch.arange(16)[:, None], best_p)
    e, p = best_e[0], best_p[0]
    for r in range(1, 16):
        take = best_e[r] < e
        if not by_range:
            take |= (best_e[r] == e) & (best_p[r] < p)
        e = torch.where(take, best_e[r], e)
        p = torch.where(take, best_p[r], p)
    return p


def _candidate_errors(pcm, state, bits):
    """Squared error of every candidate over one block, ``float32[80, L]``,
    summed in sample order (``pcm`` ``int[32, L]``, ``state`` ``int[L, 2]``):
    the recurrence of ``encode_search_lanes_plain`` without the choice."""
    f = torch.arange(80) // 16
    r = (torch.arange(80) % 16)[:, None]
    k0 = torch.tensor([0, 240, 460, 392, 488])[f][:, None]
    k1 = torch.tensor([0, 0, -208, -220, -240])[f][:, None]
    shq = 16 - bits
    down = torch.clamp(shq - r, min=0)
    up = torch.clamp(r - shq, min=0)
    a0 = torch.as_tensor(state[:, 0]).long().expand(80, -1)
    a1 = torch.as_tensor(state[:, 1]).long().expand(80, -1)
    err = torch.zeros((80, pcm.shape[1]), dtype=torch.float32)
    for n in range(32):
        x = torch.as_tensor(pcm[n]).long()[None]
        g = a0 * k0 + a1 * k1
        pred = torch.where(g < 0, -((-g) >> 8), g >> 8)
        diff = x - pred
        q = torch.where(r <= shq, (diff + ((1 << down) >> 1)) >> down,
                        diff << up)
        q = q.clamp(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
        rec = (((q << shq) >> r) + pred).clamp(-32768, 32767)
        e = (x - rec).to(torch.float32)
        err = err + e * e
        a0, a1 = rec, a0
    return err


@pytest.mark.parametrize("L", [1, 37, 256])
def test_two_level_reduction_is_first_minimum(L):
    """On error tables full of exact ties (small integers, and equal minima
    at profiles 0x0F and 0x10 in every other lane), the per-range first
    minimum followed by the lexicographic (err, profile) minimum over
    ranges is ``torch.argmin``'s first minimum, the plain search's choice."""
    rng = np.random.default_rng(L)
    err = torch.from_numpy(rng.integers(1, 4, size=(80, L)).astype(np.float32))
    err[0x0F, ::2] = 0.0
    err[0x10, ::2] = 0.0
    want = torch.argmin(err, dim=0)
    assert torch.equal(_two_level_choice(err), want)
    assert (want[::2] == 0x0F).all()


def test_range_tie_break_is_wrong():
    """0x0F (factor 0, range 15) precedes 0x10 (factor 1, range 0): a
    reduction that breaks ties by range index picks 0x10."""
    err = torch.full((80, 1), 5.0)
    err[0x0F] = err[0x10] = 1.0
    assert _two_level_choice(err).tolist() == [0x0F]
    assert _two_level_choice(err, by_range=True).tolist() == [0x10]


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_flat_signal_exposes_range_tie_break(bits):
    """The card tests' constant-per-lane signal, entered from its own
    value, has exact ties on which the range-order reduction and the first
    minimum disagree; the lexicographic one agrees with the plain search."""
    rng = np.random.default_rng(bits)
    L = 512
    c = rng.integers(-4096, 4097, size=L) >> rng.integers(0, 10, size=L)
    pcm = np.ascontiguousarray(np.broadcast_to(c, (32, L)))
    state = np.stack([c, c], axis=-1).astype(np.int32)
    err = _candidate_errors(pcm, state, bits)
    prof, *_ = cuda_encode.encode_search_lanes_plain(
        torch.from_numpy(pcm[None].astype(np.int16)),
        torch.from_numpy(state), bits=bits,
    )
    want = torch.argmin(err, dim=0)
    assert torch.equal(prof[0].long(), want)
    assert torch.equal(_two_level_choice(err), want)
    assert (_two_level_choice(err, by_range=True) != want).any()


# -- the chunk-parallel fixed point -------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("nblocks", [64, 130, 257])
def test_fixpoint_matches_sequential_and_jax(channels, nblocks):
    """Bit-identical to the port's own sequential search and to JAX's
    fixed point, rounds included, from a nonzero entry state on
    full-scale noise."""
    rng = np.random.default_rng(nblocks * channels)
    pcm = rng.integers(-32768, 32768, size=(nblocks, 32, channels)).astype(
        np.int16
    )
    state = rng.integers(-3000, 3000, size=(channels, 2)).astype(np.int32)
    tp, ts = torch.from_numpy(pcm), torch.from_numpy(state)
    *fix, rounds = encode.encode_search_fixpoint(
        tp, ts, bits=6, num_chunks=16
    )
    seq = encode.encode_search(tp, ts, bits=6)
    for f, s in zip(fix, seq):
        assert f.dtype == s.dtype
        assert torch.equal(f, s)
    *jfix, jrounds = jencode.encode_search_fixpoint(
        pcm.astype(np.int32), state, bits=6, num_chunks=16
    )
    _assert_search_equal(fix, jfix)
    assert rounds == jrounds and 1 <= rounds <= 16


def test_fixpoint_run_callable_drives_each_round():
    """The per-round search is a parameter: the loop calls it once per
    round with the chunk lanes, and its answers are what come out."""
    pcm = torch.from_numpy(_sine(100, 1, seed=9).reshape(100, 32, 1))
    calls = []

    def run(lanes, states):
        calls.append((tuple(lanes.shape), lanes.dtype, tuple(states.shape)))
        return cuda_encode.encode_search_lanes_plain(lanes, states, bits=4)

    state = torch.zeros((1, 2), dtype=torch.int32)
    *got, rounds = encode.encode_search_fixpoint(
        pcm, state, bits=4, num_chunks=6, run=run
    )
    assert len(calls) == rounds
    assert set(calls) == {((17, 32, 6), torch.int16, (6, 2))}
    for g, s in zip(got, encode.encode_search(pcm, state, bits=4)):
        assert torch.equal(g, s)


def test_pick_encode_chunks_env_matrix(monkeypatch):
    """Unset and ``auto`` give the lane sweet spot; ``0``/``off`` force
    sequential; an integer is clamped to ``nblocks // 16``; short streams
    stay sequential; anything else is a clean error."""
    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    pick = encode.pick_encode_chunks
    for env in (None, "auto"):
        if env:
            monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", env)
        assert pick(4096, 2) == 256  # nblocks // 16
        assert pick(10**6, 2) == 4096  # 8192 // channels
        assert pick(10**6, 1) == 8192
        assert pick(413438, 2) == 4096  # 5 min of stereo 44.1 kHz
        assert pick(63, 1) == 1  # short-stream floor
        assert pick(64, 1) == 4
    for off in ("0", "off"):
        monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", off)
        assert pick(4096, 2) == 1
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "512")
    assert pick(4096, 2) == 256
    assert pick(65536, 2) == 512
    assert pick(32, 2) == 1
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "yes")
    with pytest.raises(BjxaInvalidState, match="BJXA_ENCODE_FIXPOINT_CHUNKS"):
        pick(4096, 2)
    assert pick(63, 2) == 1  # the floor comes before the parse, as in JAX


# -- routing: CPU tensors take the plain version, no other device falls back --


def test_cpu_tensors_never_launch(monkeypatch):
    monkeypatch.setattr(cuda_encode, "LAUNCHES", 0)
    pcm = torch.from_numpy(_noise((2, 32, 3), seed=1))
    state = torch.zeros((3, 2), dtype=torch.int32)
    cuda_encode.encode_search_lanes(pcm, state, bits=6)
    encode.encode_search(pcm, state, bits=8)
    encode.encode_search_fixpoint(pcm, state, bits=4, num_chunks=2)
    assert cuda_encode.LAUNCHES == 0


def test_no_kernel_device_raises():
    pcm = torch.zeros((1, 32, 4), dtype=torch.int16, device="meta")
    state = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_encode.encode_search_lanes(pcm, state, bits=6)
    with pytest.raises(ValueError, match="no kernel"):
        encode.encode_search(pcm, state, bits=6)


# -- whole-file bytes -----------------------------------------------------------


def _pcm(samples, channels, seed):
    """Sine-plus-noise interleaved PCM ``int16[samples, channels]``."""
    return _sine(-(-samples // 32), channels, seed).reshape(-1, channels)[
        :samples
    ]


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("search", [True, False])
def test_encode_pcm_bytes_match_jax(bits, channels, search):
    """71 blocks, off the 32-sample grid: the port's fixed point (K = 4 by
    the ``auto`` default) against JAX's sequential CPU default."""
    samples = 70 * 32 + 5
    assert encode.pick_encode_chunks(71, channels) == 4
    pcm = _pcm(samples, channels, seed=bits + channels)
    got = tapi.encode_pcm(pcm, 44100, bits, search=search, device="cpu")
    assert got == japi.encode_pcm(pcm, 44100, bits, search=search)
    fmt = parse_xa_header(got)
    assert (fmt.samples, fmt.channels, fmt.bits, fmt.blocks) == (
        samples, channels, bits, 71
    )


@pytest.mark.parametrize("bits,channels,samples", [
    (6, 2, 37), (4, 1, 1), (8, 1, 32 * 63), (6, 1, 32 * 64 + 31),
])
def test_wav_to_xa_bytes_match_jax(bits, channels, samples):
    """Short streams (the sequential search) and the 63/64-block edge of
    the fixed point, through the WAVE entry point."""
    pcm = _pcm(samples, channels, seed=samples)
    wav = dump_riff_header(pcm.size * 2, 22050, channels) + pcm.astype(
        "<i2"
    ).tobytes()
    got = tapi.wav_to_xa(wav + b"trailing", bits, device="cpu")
    assert got == japi.wav_to_xa(wav + b"trailing", bits)


@pytest.mark.parametrize("case", ["bits", "empty", "channels", "truncated"])
def test_encode_errors_match_jax(case):
    pcm = _noise((40, 2), seed=1)
    if case == "bits":
        args = (pcm, 44100, 5)
    elif case == "empty":
        args = (pcm[:0], 44100, 6)
    elif case == "channels":
        args = (_noise((40, 3), seed=1), 44100, 6)
    if case == "truncated":
        wav = dump_riff_header(400, 44100, 2) + bytes(100)
        with pytest.raises(BjxaError) as got:
            tapi.wav_to_xa(wav, device="cpu")
        with pytest.raises(JaxError) as want:
            japi.wav_to_xa(wav)
    else:
        with pytest.raises(BjxaError) as got:
            tapi.encode_pcm(*args, device="cpu")
        with pytest.raises(JaxError) as want:
            japi.encode_pcm(*args)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert got.value.errno == want.value.errno


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_round_trip_decode_equals_recon(bits):
    """Decoding the encode gives exactly the search's reconstruction:
    filter-in-the-loop exactness, through the fixed point (70 blocks)."""
    pcm = _pcm(70 * 32, 2, seed=bits)
    xa = tapi.encode_pcm(pcm, 44100, bits, device="cpu")
    lanes = torch.from_numpy(pcm.reshape(70, 32, 2))
    *_, recon, _end, _r = encode.encode_search_fixpoint(
        lanes, torch.zeros((2, 2), dtype=torch.int32), bits=bits,
        num_chunks=encode.pick_encode_chunks(70, 2),
    )
    wav = xa_to_wav(xa, device="cpu")
    np.testing.assert_array_equal(
        np.frombuffer(wav[44:], "<i2").reshape(-1, 2),
        recon.numpy().reshape(-1, 2),
    )
