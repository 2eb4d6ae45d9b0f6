"""The search encode through the chunk fixed point on every path that
searches a long stream over few lanes (the corpus batch, the whole-file and
segmented encodes, the streaming ``Encoder``), against ``bjxa_tpu`` on the
CPU: exact equality of bytes, carried states and fixed-point rounds.

On a card these paths run one cooperative launch of
``csrc/encode_fixpoint.cu``; its plain version, which these tests drive on
the CPU, is the host loop of ``ops/encode.encode_search_fixpoint``.  The
tests marked ``cuda`` hold the kernel to the serial kernel and that loop
on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_encode_fixpoint.py

The card's machine has no JAX, so this file imports ``bjxa_tpu`` only
where a CPU test asks for it (:func:`_ref`).  Inputs are made from a numpy
seed.
"""

import dataclasses
import functools
import io
import sys
import types

import numpy as np
import pytest
import torch

import bjxa_tpu_torch.native as tnative
from bjxa_tpu_torch import cli as tcli
from bjxa_tpu_torch import codec as tcodec
from bjxa_tpu_torch import dump_riff_header
from bjxa_tpu_torch.format.riff import RiffFormat
from bjxa_tpu_torch.ops import cuda_encode, encode
from bjxa_tpu_torch.ops.encode import encode_batch_blocks, pick_encode_chunks

#: Lanes of the JAX reference batch: each case's L lanes are its first L.
REF_LANES = 33


@functools.cache
def _ref():
    """The JAX package's modules the CPU tests hold the port to."""
    import jax.numpy as jnp

    import bjxa_tpu.codec as jcodec
    import bjxa_tpu.native as jnative
    from bjxa_tpu import cli as jcli
    from bjxa_tpu.format.riff import RiffFormat as JRiff
    from bjxa_tpu.ops import encode as jencode

    return types.SimpleNamespace(jnp=jnp, jcodec=jcodec, jnative=jnative,
                                 jcli=jcli, JRiff=JRiff, jencode=jencode)


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
    j = _ref()
    flat = np.asarray(j.jencode.encode_batch_blocks(j.jnp.asarray(pcm),
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
    *want, jrounds = _ref().jencode.encode_search_fixpoint(
        pcm, state, bits=bits, num_chunks=K)
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


# -- the kernel's schedule: the items searched -----------------------------


def _host_loop_counts(pcm, state, bits, K, run):
    """The host loop's outputs and rounds, and the items the kernel's
    states-only rounds search: all K x L in the first round, then those
    whose start changed in the round before (0 when B = 0, L when K = 1)."""
    starts = []

    def record(lanes, states):
        starts.append(states.clone())
        return run(lanes, states)

    *out, rounds = encode.encode_search_fixpoint(pcm, state, bits=bits,
                                                 num_chunks=K, run=record)
    K, _ = cuda_encode.fixpoint_chunks(pcm.shape[0], K)
    searched = 0
    for r, now in enumerate(starts[:rounds]):
        searched += (now.shape[0] if r == 0 else
                     int((now != starts[r - 1]).any(dim=1).sum()))
    return out, rounds, searched


@pytest.mark.parametrize("B,L,K", [(101, 2, 6), (101, 2, 33), (300, 3, 37),
                                   (64, 1, 4), (37, 5, 1), (0, 2, 1)])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_fixpoint_plain_counts_searched(bits, B, L, K):
    """The plain version's ``searched``: the items whose start moved, a
    round at a time, from the host loop's own starts; and fewer than every
    item of every round once a chunk stops moving."""
    pcm = torch.from_numpy(_signal(B, L, seed=B + K + bits))
    state = torch.from_numpy(np.random.default_rng(bits).integers(
        -9000, 9000, (L, 2)).astype(np.int32))
    got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=bits,
                                                   num_chunks=K)
    out, rounds, searched = _host_loop_counts(
        pcm, state, bits, K, lambda x, s: cuda_encode.encode_search_lanes(
            x, s, bits=bits))
    assert got.searched.dtype == torch.int32
    assert got[4].tolist() == [rounds] and got.searched.tolist() == [searched]
    for g, w in zip(got, out):
        assert torch.equal(g, w)
    Kc, _ = cuda_encode.fixpoint_chunks(B, K)
    assert searched <= Kc * L * rounds
    if rounds > 2:
        assert searched < Kc * L * rounds


def test_fixpoint_constants_match_the_source():
    """The Python side names the kernel's tile width and its C signatures,
    which a mismatch would break only on a card."""
    import re
    from pathlib import Path

    from bjxa_tpu_torch.ops import _build

    src = (Path(cuda_encode.__file__).resolve().parents[1] / "csrc"
           / "encode_fixpoint.cu").read_text()
    m = re.search(r"constexpr int kTileWidth = (\d+);", src)
    assert m and int(m.group(1)) == cuda_encode.TILE_ITEMS
    for entry in ("bjxa_encode_fixpoint", "bjxa_encode_fixpoint_occupancy"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert sig, entry
        params = [p for p in sig.group(1).split(",") if p.strip()]
        assert len(params) == len(_build.SIGNATURES[entry]), entry


# -- the kernel on the card ----------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen_signal(B: int, L: int, seed: int) -> np.ndarray:
    """The benchmark's audio (``xabench.gen.signal``: tones, noise, clipped
    bursts) of a 15 s file's shape, as ``int16[B, 32, L]``."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from xabench import gen

    config = json.loads((root / "xabench/configs/fixture15s.json").read_text())
    spec = gen.FileSpec(0, L, 6, B * 32 - 7, config["sample_rate"])
    x = gen.signal(spec, config["signal"], seed, "cpu").numpy()
    out = np.zeros((B * 32, L), np.int16)
    out[:x.shape[0]] = x
    return out.reshape(B, 32, L)


@functools.cache
def _card_case(B, L, K, source, bits):
    """Inputs of a card case, the serial kernel's outputs, and the host
    loop's rounds and searched count (a serial launch a round)."""
    pcm = (_gen_signal if source == "gen" else _signal)(B, L, seed=B + L + K)
    state = np.random.default_rng(L + K).integers(
        -30000, 30000, (L, 2)).astype(np.int32)
    if source == "gen":
        state[:] = 0  # a file starts from the header's zero state
    dev = torch.device("cuda")
    pcm = torch.from_numpy(pcm).to(dev)
    state = torch.from_numpy(state).to(dev)
    serial = cuda_encode.encode_search_lanes(pcm, state, bits=bits)
    _, rounds, searched = _host_loop_counts(
        pcm, state, bits, K, lambda x, s: cuda_encode.encode_search_lanes(
            x, s, bits=bits))
    return pcm, state, serial, rounds, searched


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,K,source", [
    (101, 2, 6, "sine"),     # a short last chunk
    (101, 33, 7, "sine"),    # 231 items: a ragged last tile
    (101, 2, 33, "sine"),    # Bc = 4: seven whole chunks of pad
    (64, 1, 4, "sine"),      # the first block count that takes K > 1
    (37, 45, 1, "sine"),     # K = 1: no round, the pass with output alone
    (0, 2, 1, "sine"),       # no blocks
    (2048, 32, 128, "sine"),
    (20672, 1, 1292, "gen"),  # the 15 s files
    (20672, 2, 1292, "gen"),
])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_fixpoint_kernel_card(dev, bits, B, L, K, source):
    """One launch: the serial kernel's bytes and end state, the host loop's
    rounds, and the items its states-only rounds searched as the host
    loop's starts count them."""
    pcm, state, serial, rounds, searched = _card_case(B, L, K, source, bits)
    before = cuda_encode.FIXPOINT_LAUNCHES
    got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=bits,
                                                   num_chunks=K)
    assert cuda_encode.FIXPOINT_LAUNCHES == before + 1
    for g, s in zip(got[:4], serial):
        assert torch.equal(g, s)
    assert got[4].tolist() == [rounds]
    assert got.searched.tolist() == [searched]


@pytest.mark.cuda
@pytest.mark.parametrize("side", [-1, 0, 1], ids=["below", "at", "above"])
def test_fixpoint_kernel_card_at_the_full_grid(dev, side):
    """First rounds of one tile fewer than, as many as and one more than the
    card holds CTAs at once (one lane, four blocks a chunk, the last chunk
    one block): the serial kernel's bytes and the host loop's rounds and
    searched count, also where a CTA runs a second tile in round 1."""
    from bjxa_tpu_torch.ops.cuda_decode import occupancy

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    fit = occupancy("bjxa_encode_fixpoint_occupancy", 6, index) * sms
    K = (fit + side) * cuda_encode.TILE_ITEMS
    pcm, state, serial, rounds, searched = _card_case(4 * K - 3, 1, K,
                                                      "sine", 6)
    got = cuda_encode.encode_search_fixpoint_lanes(pcm, state, bits=6,
                                                   num_chunks=K)
    for g, s in zip(got[:4], serial):
        assert torch.equal(g, s)
    assert got[4].tolist() == [rounds]
    assert got.searched.tolist() == [searched]


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
    j = _ref()
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.setattr(j.jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    frames = 32 * 220 + 9
    pcm = _signal(-(-frames // 32), channels, seed=bits * channels)
    pcm = pcm.reshape(-1, channels)[:frames]
    cuts = [32 * 70, 32 * 200]
    got = _drive_encoder(tcodec, RiffFormat(frames * 2 * channels, 22050,
                                            channels), pcm, bits, cuts)
    want = _drive_encoder(j.jcodec, j.JRiff(frames * 2 * channels, 22050,
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
    want = _run_cli(_ref().jcli.main, [*args, str(tmp_path / "j")])
    assert got == want
    assert got[0] == 1 and got[1].startswith(b"converted 5 skipped 0 failed 1")
    assert pick_encode_chunks(96, 6) == 6
    for i in range(5):
        name = f"w{i}.xa"
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
