"""The fused short-stream kernel's plain versions, on the CPU, against
:func:`bjxa_tpu.ops.decode.decode_arrays`.  Exact comparison: frames, end
states and validity equal bit for bit, tolerance 0.

``decode_short_plain`` is the sequential decode of raw blocks ``uint8[C,
B, S]`` (what ``decode_arrays`` computes on the CPU);
``decode_short_chunked_plain`` runs the kernel's schedule (K chunks of Bc
blocks a channel, the last one short where Bc does not divide B, the
chunks' starts solved by the exact fixed point) and is the oracle for the
kernel's round count.  The kernel itself (``csrc/filter_lanes.cu``) is held
against both on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu_torch import parse_xa_header
from bjxa_tpu_torch.format.hexdsl import hex_to_bytes
from bjxa_tpu_torch.ops import _build, chunking
from bjxa_tpu_torch.ops import cuda_filter as cf
from bjxa_tpu_torch.ops import decode as tdecode
from test_golden_decode import SATURATION_WAV_SHA1, SATURATION_XA

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
BLOCK_COUNTS = [1, 2, 7, 15, 17, 23, 25, 49, 61]
# Payload bytes whose every sample is the largest positive / the most
# negative top-bits value at each bit depth.
SATURATE = {
    4: (np.array([0x77], np.uint8), np.array([0x88], np.uint8)),
    6: (np.array([0x7D, 0xF7, 0xDF], np.uint8),
        np.array([0x82, 0x08, 0x20], np.uint8)),
    8: (np.array([0x7F], np.uint8), np.array([0x80], np.uint8)),
}


def short_case(bits, channels, B, seed, stream="random"):
    """``(blocks uint8[C, B, S], state int32[C, 2])`` from a seed.

    "random": random payload bytes, factors 0-4, ranges 0-15, a random
    entry state; from 3 blocks on, the first quarter of the blocks
    saturates (factor 1, range 0, every sample the largest top-bits
    value: the running sum passes 32767 in the left channel and -32768 in
    the right) and block B // 2 of the last channel has an invalid factor
    (5-15).  "slow": the slow-merging stream (factor 4, range 12, payload
    bytes 0x00, 0x11, 0xEE or 0xFF: tiny residuals), whose chunk starts
    take many rounds to settle.
    """
    rng = np.random.default_rng(seed)
    S = 4 * bits + 1
    raw = rng.integers(0, 256, size=(channels, B, S), dtype=np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    if stream == "slow":
        raw[:, :, 0] = 4 << 4 | 12
        raw[:, :, 1:] = rng.choice(
            np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8), size=(channels, B,
                                                                S - 1))
        return raw, state
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(channels, B)) << 4
        | rng.integers(0, 16, size=(channels, B))
    ).astype(np.uint8)
    if B >= 3:
        sat = max(1, B // 4)
        raw[:, :sat, 0] = 0x10
        raw[0, :sat, 1:] = np.resize(SATURATE[bits][0], S - 1)
        raw[channels - 1, :sat, 1:] = np.resize(
            SATURATE[bits][channels - 1], S - 1)
        raw[channels - 1, B // 2, 0] = (
            int(rng.integers(5, 16)) << 4 | int(rng.integers(0, 16))
        )
    return raw, state


@functools.cache
def _jax(bits, channels, B):
    blocks, state = short_case(bits, channels, B, seed=31 * B + 3 * bits
                               + channels)
    frames, end, valid = jdecode.decode_arrays(
        jnp.asarray(blocks), jnp.asarray(state), bits=bits
    )
    return blocks, state, (np.asarray(frames), np.asarray(end),
                           np.asarray(valid))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("B", BLOCK_COUNTS)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_short_plains_match_jax(bits, channels, B):
    """The plain version, the wrapper's CPU route, ``decode_arrays`` and
    the chunked twin at the kernel's default chunks all give
    ``bjxa_tpu``'s frames, end state and validity."""
    blocks, state, want = _jax(bits, channels, B)
    bt, st = torch.from_numpy(blocks), torch.from_numpy(state)
    if B >= 3:
        assert want[2].sum() == B * channels - 1
    _equal(cf.decode_short_plain(bt, st, bits=bits), want)
    frames, end, valid, rounds = cf.fused_decode_short(bt, st, bits=bits)
    _equal((frames, end, valid), want)
    assert rounds.tolist() == [0]
    _equal(tdecode.decode_arrays(bt, st, bits=bits), want)
    K, _Bc = chunking.pick_short_chunks(B)
    got = cf.decode_short_chunked_plain(bt, st, bits=bits, chunks=K)
    _equal(got[:3], want)
    assert got[3] == 0 if K == 1 else 1 <= got[3] <= K
    if B >= 3:  # the clamps ran
        assert (want[0][:, 0] == 32767).any()
        assert channels == 1 or (want[0][:, 1] == -32768).any()


def _fixpoint_rounds(blocks, state, bits, K, Bc):
    """Rounds of :func:`chunking.fixpoint_states` over the K chunks of Bc
    blocks, each chunk decoded on its own by the sequential plain version
    (no lane packing, no padding)."""
    C, B, _S = blocks.shape

    def run(states_flat, with_output):
        ends = []
        for k in range(K):
            chunk = blocks[:, k * Bc:(k + 1) * Bc].contiguous()
            start = states_flat[k * C:(k + 1) * C].contiguous()
            ends.append(cf.decode_short_plain(chunk, start, bits=bits,
                                              with_output=False)[1])
        return None, torch.cat(ends)

    _starts, rounds = chunking.fixpoint_states(run, state, K, C, max_iters=K)
    return rounds


@pytest.mark.parametrize("stream", ["random", "slow"])
@pytest.mark.parametrize("B", [2, 17, 61])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("Bc", ["1", "2", "4", "8", "B"])
def test_short_chunked_rounds_and_output(Bc, channels, B, stream):
    """At Bc in {1, 2, 4, 8, B}: the chunked twin's rounds equal
    ``fixpoint_states``' over the same chunks (none at K = 1), and its
    frames, end state and validity equal the sequential plain version's,
    with and without output."""
    bits = (4, 6, 8)[B % 3]
    blocks, state = short_case(bits, channels, B, seed=B + channels,
                               stream=stream)
    bt, st = torch.from_numpy(blocks), torch.from_numpy(state)
    # the wrapper takes a chunk count: ceil(B / Bc) chunks are at most Bc
    # blocks each (17 blocks at Bc = 8 are 3 chunks of 6)
    K, bc = chunking.word_chunks(B, -(-B // (B if Bc == "B" else int(Bc))))
    assert bc <= (B if Bc == "B" else int(Bc)) and (K - 1) * bc < B <= K * bc
    want = cf.decode_short_plain(bt, st, bits=bits)
    frames, end, valid, rounds = cf.decode_short_chunked_plain(
        bt, st, bits=bits, chunks=K
    )
    assert torch.equal(frames, want[0]) and torch.equal(end, want[1])
    assert torch.equal(valid, want[2])
    assert rounds == (0 if K == 1 else _fixpoint_rounds(bt, st, bits, K, bc))
    none, end2, valid2, rounds2 = cf.decode_short_chunked_plain(
        bt, st, bits=bits, chunks=K, with_output=False
    )
    assert none is None and torch.equal(end2, want[1])
    assert torch.equal(valid2, want[2]) and rounds2 == rounds
    if stream == "slow" and K >= 8:
        assert rounds > 2  # the slow stream does exercise many rounds


@pytest.mark.parametrize("B,want", [
    (0, (1, 0)), (1, (1, 1)), (3, (1, 3)), (4, (2, 3)), (7, (3, 3)),
    (23, (8, 3)), (61, (21, 3)), (64, (22, 3)),
])
def test_pick_short_chunks(B, want):
    K, Bc = chunking.pick_short_chunks(B)
    assert (K, Bc) == want
    assert B == 0 or (K - 1) * Bc < B <= K * Bc


def test_short_constants_match_the_source():
    """The Python side names the kernel's own constant and C signature."""
    src = (CSRC / "filter_lanes.cu").read_text()
    m = re.search(r"kShortChunkBlocks = (\d+);", src)
    assert m and int(m.group(1)) == chunking.SHORT_CHUNK_BLOCKS
    for entry in ("bjxa_decode_short", "bjxa_empty_launch",
                  "bjxa_filter_lanes"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert sig, entry
        params = [p for p in sig.group(1).split(",") if p.strip()]
        assert len(params) == len(_build.SIGNATURES[entry]), entry


def test_short_plain_saturation_vector():
    """The in-repo saturation vector (3 stereo blocks, both clamps) through
    the plain version gives the known WAV's PCM."""
    import hashlib

    from bjxa_tpu_torch import dump_riff_header

    data = hex_to_bytes(SATURATION_XA)
    fmt = parse_xa_header(data)
    blocks = torch.from_numpy(tdecode.blocks_from_bytes(data[32:], fmt))
    state = torch.from_numpy(fmt.initial_state_array())
    frames, _end, valid = cf.decode_short_plain(blocks, state, bits=fmt.bits)
    assert bool(valid.all())
    pcm = frames[: fmt.samples].numpy().astype("<i2").tobytes()
    wav = dump_riff_header(len(pcm), fmt.samples_rate, fmt.channels) + pcm
    assert hashlib.sha1(wav).hexdigest() == SATURATION_WAV_SHA1


def test_short_wrapper_rejects_bad_inputs():
    blocks, state = short_case(6, 2, 5, seed=0)
    bt, st = torch.from_numpy(blocks), torch.from_numpy(state)
    with pytest.raises(ValueError):
        cf.fused_decode_short(bt, st, bits=4)  # S = 25 is not 4*4 + 1
    with pytest.raises(ValueError):
        cf.fused_decode_short(bt, st, bits=5)
    with pytest.raises(TypeError):
        cf.fused_decode_short(bt, st.long(), bits=6)
    with pytest.raises(ValueError):
        cf.fused_decode_short(bt, st[:1], bits=6)
    with pytest.raises(ValueError):
        cf.fused_decode_short(bt.transpose(0, 1), st, bits=6)
    with pytest.raises(ValueError):  # no kernel for this device
        cf.fused_decode_short(bt.to("meta"), st.to("meta"), bits=6)


def test_short_cpu_route_launches_nothing(monkeypatch):
    """On the CPU the wrapper and ``decode_arrays`` take the plain version
    and count no launch."""
    monkeypatch.setattr(cf, "SHORT_LAUNCHES", 0)
    monkeypatch.setattr(cf, "LAUNCHES", 0)
    blocks, state = short_case(8, 2, 23, seed=1)
    bt, st = torch.from_numpy(blocks), torch.from_numpy(state)
    cf.fused_decode_short(bt, st, bits=8)
    tdecode.decode_arrays(bt, st, bits=8)
    assert cf.SHORT_LAUNCHES == 0 and cf.LAUNCHES == 0


def test_empty_launch_needs_a_card():
    with pytest.raises(ValueError):
        cf.empty_launch(torch.device("cpu"))


def test_short_stream_benchmark_needs_the_card():
    """``benchmarks/short_stream.py`` refuses without a card and prints no
    result; its short stream is a valid XA image."""
    import subprocess
    import sys

    script = CSRC.parent / "benchmarks" / "short_stream.py"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 1 and res.stdout == ""
    assert "needs a CUDA card" in res.stderr
    sys.path.insert(0, str(script.parent))
    try:
        import short_stream
    finally:
        sys.path.remove(str(script.parent))
    import bjxa_tpu_torch

    xa = short_stream.short_xa(bjxa_tpu_torch, np.random.default_rng(0))
    fmt = parse_xa_header(xa)
    assert (fmt.blocks, fmt.channels, fmt.bits) == (23, 2, 8)
    assert len(bjxa_tpu_torch.xa_to_wav(xa, device="cpu")) == (
        44 + fmt.samples * 4)


def test_short_phases_variant_adds_the_stamps_alone():
    """The cycle ablation's sources are the production kernel and header
    with one ``clock64()`` stamp before each anchor and nothing else."""
    from bjxa_tpu_torch.benchmarks import short_phases as sp

    kernel, header = sp.variant_sources()
    for got, name, stamps in ((kernel, "filter_lanes.cu", sp.KERNEL_STAMPS),
                              (header, "chunk_fixpoint.cuh",
                               sp.HEADER_STAMPS)):
        prod = (CSRC / name).read_text()
        kept = [line for line in got.splitlines() if "g_stamp" not in line]
        extra = sp.READ.splitlines() if name == "filter_lanes.cu" else []
        assert kept == prod.splitlines() + [ln for ln in extra
                                            if "g_stamp" not in ln]
        assert got.count("= clock64();") == len(stamps)


def test_short_phases_needs_the_card(monkeypatch):
    from bjxa_tpu_torch.benchmarks import short_phases as sp
    from bjxa_tpu_torch.benchmarks._common import NoDeviceError

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    with pytest.raises(NoDeviceError):
        sp.main()
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    with pytest.raises(NoDeviceError):
        sp.main()
