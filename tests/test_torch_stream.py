"""The whole-file stream kernel's plain versions, its chunk choice and the
card branch's staging, on the CPU, against :mod:`bjxa_tpu.ops.decode`.
Exact comparison: PCM and end states equal bit for bit, tolerance 0.

``fused_decode_stream_plain`` is the sequential decode of the payload in
the file's own byte layout; ``fused_decode_stream_chunked_plain`` runs the
kernel's schedule (K chunks a channel, the last one short where K does not
divide B, the chunks' starts solved by the exact fixed point) and is the
oracle for the kernel's round count.  The kernel itself is held against
both on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu_torch import parse_xa_header
from bjxa_tpu_torch.benchmarks import stream_store
from bjxa_tpu_torch.benchmarks._common import NoDeviceError
from bjxa_tpu_torch.ops import chunking
from bjxa_tpu_torch.ops import cuda_decode as cd
from bjxa_tpu_torch.ops import cuda_decode_words as cdw
from bjxa_tpu_torch.ops import decode as tdecode
from test_torch_decode import make_xa

REPO = Path(__file__).resolve().parent.parent


def _stream(data):
    """``(fmt, payload uint8[B*C*S], state int32[C, 2])`` of an XA image."""
    fmt = parse_xa_header(data)
    payload = torch.frombuffer(bytearray(data[32:32 + fmt.data_len]),
                               dtype=torch.uint8)
    return fmt, payload, torch.from_numpy(fmt.initial_state_array())


@functools.cache
def _reference(bits, channels, B):
    """A seeded stream, ``bjxa_tpu``'s decode of it and the sequential
    plain version's frames and end state."""
    data = make_xa(bits, channels, B, seed=7 * B + bits + channels)
    fmt, payload, state = _stream(data)
    want = jdecode.decode_bytes(data[32:], fmt)
    frames, end = cd.fused_decode_stream_plain(payload, state, bits=bits,
                                               channels=channels)
    return data, want, frames, end


@pytest.mark.parametrize("K", ["1", "2", "B//8", "B"])
@pytest.mark.parametrize("B", [17, 97, 1000])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_stream_plains_match_jax(bits, channels, B, K):
    """Both plain versions give ``bjxa_tpu.decode_bytes``'s PCM, and the
    same end state, with and without output; a prime B leaves a short last
    chunk at every K but 1 and B."""
    data, want, seq_frames, seq_end = _reference(bits, channels, B)
    fmt, payload, state = _stream(data)
    chunks = {"1": 1, "2": 2, "B//8": B // 8, "B": B}[K]
    assert seq_frames.dtype == torch.int16
    assert tuple(seq_frames.shape) == (B * 32, channels)
    np.testing.assert_array_equal(seq_frames[: fmt.samples].numpy(), want)
    frames, end, rounds = cd.fused_decode_stream_chunked_plain(
        payload, state, bits=bits, channels=channels, chunks=chunks)
    np.testing.assert_array_equal(frames.numpy(), seq_frames.numpy())
    assert end.dtype == torch.int32 and torch.equal(end, seq_end)
    none, s_end, s_rounds = cd.fused_decode_stream_chunked_plain(
        payload, state, bits=bits, channels=channels, chunks=chunks,
        with_output=False)
    assert none is None and s_rounds == rounds and torch.equal(s_end, end)
    K_eff, _Bc = cd.word_chunks(B, chunks)
    assert (rounds == 0) if K_eff == 1 else (1 <= rounds <= K_eff)


def _slow_merging(bits, channels, B, seed):
    """Factor 4 (the filter that forgets slowest), range 12 and payload
    bytes near zero in the file's byte layout: chunk starts that begin
    wrong stay wrong for many blocks."""
    rng = np.random.default_rng(seed)
    raw = rng.choice(np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8),
                     size=(B, channels, 4 * bits + 1))
    raw[:, :, 0] = 4 << 4 | 12
    state = rng.integers(-(2**15), 2**15, size=(channels, 2))
    return (torch.from_numpy(raw.reshape(-1).copy()),
            torch.from_numpy(state.astype(np.int32)))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_slow_merging_stream_stays_exact(bits, channels):
    """K = B (one block a chunk): more than two rounds, at most K, and the
    sequential decode's frames and end state all the same."""
    B = 23
    payload, state = _slow_merging(bits, channels, B, seed=bits + channels)
    frames, end, rounds = cd.fused_decode_stream_chunked_plain(
        payload, state, bits=bits, channels=channels, chunks=B)
    seq_frames, seq_end = cd.fused_decode_stream_plain(
        payload, state, bits=bits, channels=channels)
    assert 2 < rounds <= B
    assert torch.equal(frames, seq_frames) and torch.equal(end, seq_end)


@pytest.mark.parametrize("channels", [1, 2])
def test_stream_no_blocks(channels):
    payload = torch.zeros(0, dtype=torch.uint8)
    state = torch.tensor([[5, -6], [7, -8]][:channels], dtype=torch.int32)
    for plain in (
        lambda: cd.fused_decode_stream_plain(payload, state, bits=6,
                                             channels=channels),
        lambda: cd.fused_decode_stream_chunked_plain(
            payload, state, bits=6, channels=channels, chunks=4)[:2],
    ):
        frames, end = plain()
        assert tuple(frames.shape) == (0, channels)
        assert torch.equal(end, state)


@pytest.mark.parametrize("B", [1, 7, 8, 9, 64, 65, 97, 1000, 20736, 65536,
                               413438, 2**21])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sms", [1, 132])
def test_pick_stream_chunks_properties(B, channels, sms):
    K, Bc = cd.pick_stream_chunks(B, channels, sms)
    assert Bc >= tdecode.MIN_CHUNK_BLOCKS and Bc % 4 == 0
    assert K * Bc >= B > (K - 1) * Bc  # no chunk is empty


def test_pick_stream_chunks_at_the_main_path():
    """The 5-minute stereo stream on 132 SMs: 20-block chunks, 41,344
    work items (320 an SM, the words kernel's rule)."""
    assert cd.pick_stream_chunks(413438, 2, 132) == (20672, 20)
    assert cd.pick_stream_chunks(65536, 2, 132) == (8192, 8)
    assert cd.pick_stream_chunks(0, 2, 132) == (1, 0)


def test_stream_kernel_refuses_cpu_tensors():
    """A CPU tensor never reaches a kernel and never falls back."""
    payload = torch.zeros(2 * 25, dtype=torch.uint8)
    state = torch.zeros((2, 2), dtype=torch.int32)
    before = cd.STREAM_LAUNCHES
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cd.fused_decode_stream(payload, state, bits=6, channels=2)
    assert cd.STREAM_LAUNCHES == before


@pytest.mark.parametrize("bad", ["bits", "channels", "dtype", "length",
                                 "state"])
def test_stream_plain_rejects_bad_inputs(bad):
    payload = torch.zeros(4 * 2 * 25, dtype=torch.uint8)
    state = torch.zeros((2, 2), dtype=torch.int32)
    kw = dict(bits=6, channels=2)
    if bad == "bits":
        kw["bits"] = 5
    elif bad == "channels":
        kw["channels"] = 3
    elif bad == "dtype":
        payload = payload.to(torch.int32)
    elif bad == "length":
        payload = payload[:-1]
    else:
        state = state[:1]
    with pytest.raises((TypeError, ValueError)):
        cd.fused_decode_stream_plain(payload, state, **kw)


@pytest.mark.parametrize("bits,channels,blocks,bad", [
    (6, 2, 200, None), (4, 1, 1000, None), (8, 2, 97, None), (6, 2, 300, 211),
])
def test_card_branch_staging_matches_cpu_path(monkeypatch, bits, channels,
                                              blocks, bad):
    """The card branch's staging (one host copy, the validity plane read
    from the profile bytes, the frames unpadded) around the chunked plain
    version in place of the kernel gives the CPU path's frames and
    validity, past an invalid profile too (both decode its garbage
    gains alike)."""
    data = make_xa(bits, channels, blocks, seed=blocks + bits, bad_block=bad)
    fmt = parse_xa_header(data)
    calls = []

    def kernel(payload, state, *, bits, channels):
        calls.append(payload.shape)
        return cd.fused_decode_stream_chunked_plain(
            payload, state, bits=bits, channels=channels, chunks=blocks // 8)

    monkeypatch.setattr(tdecode, "fused_decode_stream", kernel)
    state = torch.from_numpy(fmt.initial_state_array())
    frames, valid = tdecode._decode_payload_stream(
        memoryview(data)[32:], fmt, state, torch.device("cpu"))
    want_frames, want_valid = tdecode.decode_bytes_validity(
        data[32:], fmt, device="cpu")
    assert calls == [(blocks * channels * (4 * bits + 1),)]
    assert tuple(frames.shape) == (blocks * 32, channels)
    assert torch.equal(valid, want_valid)
    assert torch.equal(frames, want_frames[: blocks * 32])


@pytest.mark.parametrize("bits,channels,blocks", [(6, 2, 200), (4, 1, 97)])
def test_card_branch_stages_compose_it(monkeypatch, bits, channels, blocks):
    """The card branch is its three stage functions in a row (the smoke
    run's stage split times these same functions): the host stage copies
    exactly the payload's blocks (trailing bytes dropped) into a tensor of
    its own, the upload keeps them, and the device stage decodes them."""
    data = make_xa(bits, channels, blocks, seed=blocks) + b"\x5a" * 7
    fmt = parse_xa_header(data)
    host = tdecode.stream_payload_host(memoryview(data)[32:], fmt)
    size = blocks * channels * (4 * bits + 1)
    assert host.dtype == torch.uint8 and tuple(host.shape) == (size,)
    assert bytes(host.numpy()) == data[32:32 + size]
    host[0] ^= 0xFF  # a copy: the file's bytes stay as they were
    assert data[32] != int(host[0])
    host[0] ^= 0xFF
    pay = tdecode.stream_payload_upload(host, torch.device("cpu"))
    assert torch.equal(pay, host)
    monkeypatch.setattr(
        tdecode, "fused_decode_stream",
        lambda p, s, *, bits, channels: cd.fused_decode_stream_chunked_plain(
            p, s, bits=bits, channels=channels, chunks=blocks // 8))
    state = torch.from_numpy(fmt.initial_state_array())
    frames, valid = tdecode.stream_decode_on_device(pay, fmt, state)
    whole = tdecode._decode_payload_stream(memoryview(data)[32:], fmt, state,
                                           torch.device("cpu"))
    assert torch.equal(frames, whole[0]) and torch.equal(valid, whole[1])


@pytest.mark.parametrize("store", stream_store.STORES)
def test_stream_store_variants_change_the_store_alone(store):
    """``vec`` is the production source; ``i16`` differs from it in the
    frame store alone."""
    prod = (stream_store._build.CSRC / "decode_stream.cu").read_text()
    var = stream_store.variant_source(store)
    assert (var == prod) == (store == "vec")
    if store == "i16":
        assert stream_store.PACK not in var and stream_store.STORE not in var
        back = var.replace(stream_store.I16, stream_store.PACK, 1)
        i = prod.index(stream_store.STORE)
        assert back[:i] + stream_store.STORE + back[i:] == prod


def test_stream_store_needs_the_card(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    with pytest.raises(NoDeviceError, match="needs the card"):
        stream_store.main()
    with pytest.raises(ValueError, match="store"):
        stream_store.variant_source("i32")


def test_schedule_module_stands_alone():
    """``ops/chunking`` imports nothing of the package (so the pipeline and
    both kernel wrappers import it at the top), everyone shares its names,
    and its CTA size is the kernels' ``kThreads``; the store ablation
    imports no JAX."""
    tree = ast.parse(Path(chunking.__file__).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert imported == {"__future__", "torch"}
    probe = (
        "import sys\n"
        "import bjxa_tpu_torch.benchmarks.stream_store\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'bjxa_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert tdecode.fixpoint_states is chunking.fixpoint_states
    assert cdw.word_chunks is cd.word_chunks is chunking.word_chunks
    assert tdecode.MIN_CHUNK_BLOCKS is chunking.MIN_CHUNK_BLOCKS
    assert cdw.TARGET_LANES_PER_SM is chunking.TARGET_LANES_PER_SM
    header = (stream_store._build.CSRC / "adpcm.cuh").read_text()
    assert f"constexpr int kThreads = {chunking.CTA_THREADS};" in header
