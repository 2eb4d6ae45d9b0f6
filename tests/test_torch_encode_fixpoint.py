"""The search encode through the chunk fixed point on every path that
searches a long stream over few lanes (the corpus batch, the whole-file and
segmented encodes, the streaming ``Encoder``), against ``bjxa_tpu`` on the
CPU: exact equality of bytes, carried states and fixed-point rounds.

On a card these paths run one cooperative launch of
``csrc/encode_fixpoint.cu``; its plain version, which these tests drive on
the CPU, is the host loop of ``ops/encode.encode_search_fixpoint``.  The
kernel itself is held against that loop on the card in
``tests/test_torch_cuda.py``.  Inputs are made from a numpy seed.
"""

import dataclasses
import functools
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bjxa_tpu.codec as jcodec
import bjxa_tpu.native as jnative
import bjxa_tpu_torch.native as tnative
from bjxa_tpu import cli as jcli
from bjxa_tpu.format.riff import RiffFormat as JRiff
from bjxa_tpu.ops import encode as jencode
from bjxa_tpu_torch import cli as tcli
from bjxa_tpu_torch import codec as tcodec
from bjxa_tpu_torch import dump_riff_header
from bjxa_tpu_torch.format.riff import RiffFormat
from bjxa_tpu_torch.ops import cuda_encode, encode
from bjxa_tpu_torch.ops.encode import encode_batch_blocks, pick_encode_chunks

#: Lanes of the JAX reference batch: each case's L lanes are its first L.
REF_LANES = 33


def _signal(B: int, L: int, seed: int) -> np.ndarray:
    """Sine plus noise, ``int16[B, 32, L]``, a different pitch a lane."""
    rng = np.random.default_rng(seed)
    t = np.arange(B * 32)[:, None]
    sig = 14000 * np.sin(t / (4.0 + 0.7 * np.arange(L)))
    sig += rng.normal(0, 2500, size=(B * 32, L))
    return np.clip(sig, -32768, 32767).astype(np.int16).reshape(B, 32, L)


@functools.cache
def _jax_batch(bits: int, B: int, search: bool) -> np.ndarray:
    """``bjxa_tpu``'s corpus-batch bytes of REF_LANES lanes, as
    ``uint8[B, REF_LANES, block]``: lanes never interact, so a case's
    first L lanes are its own batch's bytes."""
    pcm = _signal(B, REF_LANES, seed=B)
    flat = np.asarray(jencode.encode_batch_blocks(jnp.asarray(pcm),
                                                  bits=bits, search=search))
    return flat.reshape(B, REF_LANES, -1)


@pytest.mark.parametrize("search", [True, False], ids=["search", "truncate"])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("L", [1, 2, 31, 32, 33])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_encode_batch_blocks_matches_jax(bits, L, B, search):
    """The corpus batch, through the fixed point from 64 blocks on (K =
    ``pick_encode_chunks(B, L)``), against the JAX package's one sequential
    search over the same lanes."""
    pcm = _signal(B, REF_LANES, seed=B)[:, :, :L]
    got = encode_batch_blocks(torch.from_numpy(np.ascontiguousarray(pcm)),
                              bits=bits, search=search)
    want = _jax_batch(bits, B, search)[:, :L]
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().reshape(B, L, -1), want)
    assert pick_encode_chunks(B, L) == (1 if B < 64 else
                                        min(8192 // L, B // 16))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("K", [2, 7, "B//16", 33])
def test_fixpoint_matches_jax_rounds_included(K, bits, channels):
    """``encode_search_fixpoint`` (the kernel's plain version) against
    ``bjxa_tpu.ops.encode.encode_search_fixpoint`` from a nonzero entry
    state: outputs, end state and rounds.  B = 101 leaves a short last
    chunk at every K (51 + 50, 6 x 15 + 11, 5 x 17 + 16); at K = 33 (Bc =
    4) seven whole chunks are pad, whose end states take part in the
    equality test of every round."""
    B = 101
    K = B // 16 if K == "B//16" else K
    rng = np.random.default_rng(K * 10 + bits + channels)
    pcm = _signal(B, channels, seed=K + bits)
    state = rng.integers(-30000, 30000, size=(channels, 2)).astype(np.int32)
    *got, rounds = encode.encode_search_fixpoint(
        torch.from_numpy(pcm), torch.from_numpy(state), bits=bits,
        num_chunks=K)
    *want, jrounds = jencode.encode_search_fixpoint(pcm, state, bits=bits,
                                                    num_chunks=K)
    assert rounds == jrounds and 1 <= rounds <= K
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("K", [1, 3, 40])
def test_fixpoint_lanes_plain_is_the_host_loop(K):
    """The wrapper's plain version: the host loop over the plain search,
    its rounds in a one-element int32 tensor, and the sequential search's
    bytes; a CPU tensor never launches."""
    B, L = 77, 3
    pcm = torch.from_numpy(_signal(B, L, seed=K))
    state = torch.from_numpy(
        np.random.default_rng(K).integers(-9000, 9000, (L, 2)).astype(
            np.int32))
    before = cuda_encode.FIXPOINT_LAUNCHES
    *got, rounds = cuda_encode.encode_search_fixpoint_lanes(
        pcm, state, bits=6, num_chunks=K)
    *loop, loop_rounds = encode.encode_search_fixpoint(pcm, state, bits=6,
                                                       num_chunks=K)
    seq = cuda_encode.encode_search_lanes(pcm, state, bits=6)
    assert cuda_encode.FIXPOINT_LAUNCHES == before
    assert rounds.dtype == torch.int32 and rounds.tolist() == [loop_rounds]
    for g, lp, s in zip(got, loop, seq):
        assert torch.equal(g, lp) and torch.equal(g, s)


def test_fixpoint_no_blocks_ends_at_the_entry_state():
    """B = 0: no round runs, the outputs are empty, the end is the entry
    state."""
    state = torch.tensor([[5, -7], [32767, -32768]], dtype=torch.int32)
    pcm = torch.zeros((0, 32, 2), dtype=torch.int16)
    prof, coded, recon, end, rounds = (
        cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                 num_chunks=3))
    assert prof.shape == (0, 2) and coded.shape == recon.shape == (0, 32, 2)
    assert torch.equal(end, state) and rounds.tolist() == [0]


def test_fixpoint_chunks_is_the_host_loops_cut():
    assert cuda_encode.fixpoint_chunks(0, 5) == (1, 0)
    assert cuda_encode.fixpoint_chunks(1601, 100) == (100, 17)
    assert cuda_encode.fixpoint_chunks(3, 7) == (7, 1)
    with pytest.raises(ValueError):
        cuda_encode.fixpoint_chunks(10, 0)


def test_fixpoint_lanes_rejects_other_devices():
    pcm = torch.zeros((1, 32, 4), dtype=torch.int16, device="meta")
    state = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                 num_chunks=2)


@pytest.mark.parametrize("B,L", [(40, 2), (64, 2), (200, 5)])
def test_encode_search_auto_equals_sequential(B, L):
    """Every caller's search: the fixed point where K > 1, else one
    sequential search; both give the sequential bytes and end state."""
    pcm = torch.from_numpy(_signal(B, L, seed=B + L))
    state = torch.from_numpy(
        np.random.default_rng(B).integers(-9000, 9000, (L, 2)).astype(
            np.int32))
    got = encode.encode_search_auto(pcm, state, bits=4)
    for g, w in zip(got, encode.encode_search(pcm, state, bits=4)):
        assert torch.equal(g, w)


def _drive_encoder(mod, riff, pcm, bits, cuts):
    """Search-encode ``pcm`` in pieces cut at ``cuts``: each call's bytes,
    then the carried state and progress after it."""
    enc = mod.Encoder(device="cpu") if mod is tcodec else mod.Encoder()
    enc.init(riff, bits)
    out, pos = [enc.dump_header()], 0
    for cut in [*cuts, len(pcm)]:
        out.append(enc.encode(pcm[pos:cut], search=True))
        pos = cut
        out.append((enc._state.tolist(), dataclasses.asdict(enc.format())))
    return out


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_streaming_encoder_matches_jax(monkeypatch, bits, channels):
    """The ``Encoder`` without the native library, on the CPU: calls of 70
    and 130 blocks go through the fixed point (K = 4 and 8), the last one
    of 20 blocks and a partial block through the sequential search; the
    bytes and the carried state after every call equal ``bjxa_tpu``'s."""
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    frames = 32 * 220 + 9
    pcm = _signal(-(-frames // 32), channels, seed=bits * channels)
    pcm = pcm.reshape(-1, channels)[:frames]
    cuts = [32 * 70, 32 * 200]
    got = _drive_encoder(tcodec, RiffFormat(frames * 2 * channels, 22050,
                                            channels), pcm, bits, cuts)
    want = _drive_encoder(jcodec, JRiff(frames * 2 * channels, 22050,
                                        channels), pcm, bits, cuts)
    assert got == want
    assert pick_encode_chunks(130, channels) == 8


def _run_cli(main, args):
    """``main(["bjxa", *args])`` with captured stdout and stderr: (code,
    stdout bytes, stderr text)."""
    out, err = io.BytesIO(), io.StringIO()

    class Out:
        buffer = out

        @staticmethod
        def write(text):
            out.write(text.encode())

    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = Out(), err
    try:
        code = main(["bjxa", *args])
    finally:
        sys.stdout, sys.stderr = old
    return code, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("bits", ["4", "6", "8"])
def test_corpus_encode_cli_matches_jax(monkeypatch, tmp_path, bits):
    """``corpus --encode`` through both CLIs on the CPU (the JAX one on one
    device): files of 96 blocks, so the batch of their 6 lanes takes the
    fixed point (K = 6), a short one and a file that fails; the same XA
    bytes, stdout and stderr."""
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    src = tmp_path / "wav"
    src.mkdir()
    for i, (ch, frames) in enumerate([(1, 3072), (2, 3050), (2, 3072),
                                      (1, 3000), (2, 700)]):
        pcm = _signal(-(-frames // 32), ch, seed=i).reshape(-1, ch)[:frames]
        (src / f"w{i}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, ch)
            + pcm.astype("<i2").tobytes())
    (src / "junk.wav").write_bytes(b"RIFF")
    args = ["corpus", "--encode", "--bits", bits, str(src)]
    monkeypatch.delenv("BJXA_DEVICES", raising=False)
    got = _run_cli(tcli.main, [*args, str(tmp_path / "t")])
    monkeypatch.setenv("BJXA_DEVICES", "1")
    want = _run_cli(jcli.main, [*args, str(tmp_path / "j")])
    assert got == want
    assert got[0] == 1 and got[1].startswith(b"converted 5 skipped 0 failed 1")
    assert pick_encode_chunks(96, 6) == 6
    for i in range(5):
        name = f"w{i}.xa"
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
