"""The PyTorch port's corpus engine and batch encode against
:mod:`bjxa_tpu`, both on the CPU.  Exact comparison: WAV and XA bytes,
failures (paths and messages), counters and the manifest.

Batches are small (a few files, tens of blocks, ``bucket_granularity`` 16
or 4) so the plain filter and the plain search stay quick; the card runs
the same code through the kernels in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import builtins
import shutil
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops.encode import encode_batch_blocks as jax_batch_encode
from bjxa_tpu.parallel import corpus as jcorpus
from bjxa_tpu_torch import XAFormat, dump_riff_header, dump_xa_header
from bjxa_tpu_torch.api import encode_pcm, xa_to_wav
from bjxa_tpu_torch.ops.encode import encode_batch_blocks
from bjxa_tpu_torch.parallel import corpus as tcorpus

CPU = torch.device("cpu")


def make_xa(bits, channels, blocks, seed, bad=None):
    """A valid XA file image from a seed: random payload, valid profiles,
    a random initial state; ``bad`` = (block, channel) gets an invalid
    profile factor."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(blocks, channels, 4 * bits + 1),
                       dtype=np.uint8)
    raw[:, :, 0] = (
        rng.integers(0, 5, size=(blocks, channels)) << 4
        | rng.integers(0, 13, size=(blocks, channels))
    ).astype(np.uint8)
    if bad is not None:
        raw[bad[0], bad[1], 0] = 0x9C
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


# name -> (bits, channels, blocks); two (6, 2) and (4, 1) groups hold three
# files each, of different lengths inside one bucket, so --batch-files 2
# splits them
CORPUS = {
    "a_s6_40": (6, 2, 40), "a_s6_45": (6, 2, 45), "a_s6_48": (6, 2, 48),
    "b_m4_20": (4, 1, 20), "b_m4_25": (4, 1, 25), "b_m4_31": (4, 1, 31),
    "c_m8_70": (8, 1, 70), "d_s8_9": (8, 2, 9), "e_s4_17": (4, 2, 17),
    "f_m6_100": (6, 1, 100),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The shared source directory (tests that change it copy it first):
    the files above, an invalid-profile file, a truncated payload and a
    file that is not XA."""
    src = tmp_path_factory.mktemp("corpus") / "src"
    src.mkdir()
    for i, (name, (bits, ch, blocks)) in enumerate(CORPUS.items()):
        (src / f"{name}.xa").write_bytes(make_xa(bits, ch, blocks, seed=i))
    (src / "g_bad_profile.xa").write_bytes(
        make_xa(6, 2, 44, seed=50, bad=(30, 1))
    )
    (src / "h_truncated.xa").write_bytes(make_xa(8, 1, 60, seed=51)[:-40])
    (src / "i_not_xa.xa").write_bytes(b"RIFF" + bytes(60))
    return src


def _outputs(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.wav"))}


def _counts(res):
    c = res.counters
    return (res.converted, res.skipped, res.failed,
            (c.files, c.blocks, c.samples, c.bytes_in, c.bytes_out))


def _jax_decode(src, out, **kw):
    return jcorpus.decode_corpus(src, out, **kw)


@pytest.mark.parametrize("batch_files,depth", [(2, 1), (2, 3), (64, 3)])
def test_decode_corpus_matches_jax(tmp_path, corpus, batch_files, depth):
    kw = dict(batch_files=batch_files, bucket_granularity=16, depth=depth)
    res = tcorpus.decode_corpus(corpus, tmp_path / "t", device=CPU, **kw)
    want = _jax_decode(corpus, tmp_path / "j", **kw)
    assert _counts(res) == _counts(want)
    got = _outputs(tmp_path / "t")
    assert got == _outputs(tmp_path / "j")
    assert res.converted == len(CORPUS) and len(got) == len(CORPUS)
    assert set(res.failed) == {
        str(corpus / f"{n}.xa")
        for n in ("g_bad_profile", "h_truncated", "i_not_xa")
    }
    # and each WAV is the port's own whole-file decode
    for name in CORPUS:
        data = (corpus / f"{name}.xa").read_bytes()
        assert got[f"{name}.wav"] == xa_to_wav(data, device=CPU)
    assert not list((tmp_path / "t").glob("*.tmp"))


def test_decode_corpus_rerun_skips_everything(tmp_path, corpus):
    out = tmp_path / "out"
    first = tcorpus.decode_corpus(corpus, out, device=CPU,
                                  bucket_granularity=16)
    assert (out / ".bjxa-manifest-0.jsonl").exists()
    again = tcorpus.decode_corpus(corpus, out, device=CPU,
                                  bucket_granularity=16)
    assert again.converted == 0 and again.skipped == first.converted
    assert set(again.failed) == set(first.failed)  # failures retry
    custom = tmp_path / "m.jsonl"
    res = tcorpus.decode_corpus(corpus, tmp_path / "o2", device=CPU,
                                bucket_granularity=16, manifest_path=custom)
    assert custom.exists() and res.converted == first.converted


def test_decode_corpus_process_shares_match_jax(tmp_path, corpus):
    for rank in range(2):
        kw = dict(bucket_granularity=16, process_index=rank, process_count=2)
        res = tcorpus.decode_corpus(corpus, tmp_path / f"t{rank}",
                                    device=CPU, **kw)
        want = _jax_decode(corpus, tmp_path / f"j{rank}", **kw)
        assert _counts(res) == _counts(want)
        assert (tmp_path / f"t{rank}" / f".bjxa-manifest-{rank}.jsonl").exists()
        assert _outputs(tmp_path / f"t{rank}") == _outputs(
            tmp_path / f"j{rank}"
        )


def test_decode_corpus_explicit_paths_match_jax(tmp_path, corpus):
    paths = [corpus / "c_m8_70.xa", corpus / "h_truncated.xa",
             corpus / "a_s6_45.xa"]
    res = tcorpus.decode_corpus(paths, tmp_path / "t", device=CPU)
    want = _jax_decode(paths, tmp_path / "j")
    assert _counts(res) == _counts(want)
    assert res.failed[str(paths[1])] == "truncated payload"
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")


def test_decode_corpus_oversized_files_match_jax(tmp_path, corpus,
                                                 monkeypatch):
    """Every file above the segmentation threshold: the port's segmented
    route gives the bytes and failures of bjxa_tpu's."""
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "1")
    res = tcorpus.decode_corpus(corpus, tmp_path / "t", device=CPU)
    want = _jax_decode(corpus, tmp_path / "j")
    assert _counts(res) == _counts(want)
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")
    again = tcorpus.decode_corpus(corpus, tmp_path / "t", device=CPU)
    assert again.converted == 0 and again.skipped == len(CORPUS)


@pytest.mark.parametrize("names,n_alloc,blocks", [
    (("a_s6_40", "a_s6_45", "a_s6_48"), 3, 48),
    (("b_m4_20", "b_m4_31"), 4, 32),
    (("c_m8_70",), 1, 80),
])
def test_stage_decode_batch_matches_jax_layout(corpus, names, n_alloc,
                                               blocks):
    """The corpus engine's packed staging equals the layout bjxa_tpu's
    words_from_blocks_host and packed_layout give the same lanes, padding
    lanes and blocks included."""
    from bjxa_tpu.ops.decode import packed_layout as jax_packed_layout
    from bjxa_tpu.ops.decode import words_from_blocks_host as jax_words
    from bjxa_tpu_torch import parse_xa_header

    chunk = [(corpus / f"{n}.xa",
              parse_xa_header((corpus / f"{n}.xa").read_bytes()))
             for n in names]
    bits, channels = chunk[0][1].bits, chunk[0][1].channels
    L = n_alloc * channels
    failed = {}
    buf, valid, dead = tcorpus.stage_decode_batch(
        chunk, bits, channels, blocks, L, failed, CPU
    )
    assert not failed and not dead
    blocks_t = np.zeros((blocks, 4 * bits + 1, L), np.uint8)
    state = np.zeros((L, 2), np.int32)
    for i, (path, fmt) in enumerate(chunk):
        raw = np.frombuffer(path.read_bytes()[32:], np.uint8).reshape(
            fmt.blocks, channels, -1)
        blocks_t[: fmt.blocks, :, i * channels:(i + 1) * channels] = (
            raw.transpose(0, 2, 1))
        state[i * channels:(i + 1) * channels] = fmt.initial_state_array()
    prof, words = jax_words(blocks_t, bits)
    nw, npr, nst = jax_packed_layout(blocks, L, bits)
    prof_words = np.zeros(npr * 4, np.uint8)
    prof_words[: prof.size] = prof.reshape(-1)
    want = np.concatenate([words.reshape(-1), prof_words.view("<i4"),
                           state.reshape(-1)])
    assert buf.dtype == torch.int32 and buf.numel() == nw + npr + nst
    np.testing.assert_array_equal(buf.numpy(), want)
    np.testing.assert_array_equal(valid, (prof >> 4) < 5)


@pytest.mark.parametrize("engine", ["decode", "encode"])
def test_corpus_stage_spans(tmp_path, corpus, wavs, engine):
    """Each run reports the host time of its stages; on the CPU no device
    stage is timed."""
    if engine == "decode":
        res = tcorpus.decode_corpus(corpus, tmp_path / "o", device=CPU,
                                    batch_files=2, bucket_granularity=16)
    else:
        res = tcorpus.encode_corpus(wavs[0], tmp_path / "o", device=CPU,
                                    batch_files=2, bucket_granularity=4)
    spans = res.counters.stage_ms
    assert set(spans) == {"parse", "stage", "launch", "readback", "queue",
                          "write", "drain"}
    assert all(ms >= 0.0 for ms in spans.values())
    assert sum(spans.values()) > 0.0


class _ShrinkingOpen:
    """builtins.open wrapper: after ``after`` opens of ``target``, reads
    return ``drop`` bytes fewer than asked (the file shrank after its
    header was parsed)."""

    def __init__(self, real_open, target, after=1, drop=10):
        self.real_open = real_open
        self.target = str(target)
        self.after = after
        self.drop = drop
        self.n = 0

    def __call__(self, file, *a, **k):
        f = self.real_open(file, *a, **k)
        if str(file) == self.target:
            self.n += 1
            if self.n > self.after:
                real_read = f.read

                def short_read(nbytes=-1):
                    data = real_read(nbytes)
                    return data[: max(len(data) - self.drop, 0)]

                f.read = short_read
        return f


class _VanishingOpen:
    """builtins.open wrapper: every open of ``target`` after the first
    fails (the file vanished after its header was parsed)."""

    def __init__(self, real_open, target):
        self.real_open = real_open
        self.target = str(target)
        self.n = 0

    def __call__(self, file, *a, **k):
        if str(file) == self.target:
            self.n += 1
            if self.n > 1:
                raise OSError("vanished")
        return self.real_open(file, *a, **k)


@pytest.mark.parametrize("how", ["vanish", "shrink", "shrink_huge",
                                 "shrink_huge_bad"])
def test_decode_corpus_file_changes_after_parse(tmp_path, corpus,
                                                monkeypatch, how):
    """A file that vanishes or shrinks between the header parse and its
    staging degrades per file, with bjxa_tpu's message; the rest of its
    batch converts."""
    work = tmp_path / "src"
    shutil.copytree(corpus, work)
    target = work / ("a_s6_45.xa" if how != "shrink_huge_bad"
                     else "g_bad_profile.xa")
    if how.startswith("shrink_huge"):
        monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "1")
    real_open = builtins.open
    results = []
    for run, out in ((tcorpus.decode_corpus, tmp_path / "t"),
                     (_jax_decode, tmp_path / "j")):
        fake = (_VanishingOpen(real_open, target) if how == "vanish"
                else _ShrinkingOpen(real_open, target, drop=60))
        monkeypatch.setattr(builtins, "open", fake)
        kw = {"device": CPU} if run is tcorpus.decode_corpus else {}
        results.append(run(work, out, bucket_granularity=16,
                           batch_files=2, **kw))
        monkeypatch.setattr(builtins, "open", real_open)
    res, want = results
    assert _counts(res) == _counts(want)
    assert str(target) in res.failed
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")
    assert not list((tmp_path / "t").glob("*.tmp"))


# -- batch encode and encode corpus -----------------------------------------


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("L", [1, 2, 5])
def test_encode_batch_blocks_matches_jax(bits, L, search):
    rng = np.random.default_rng(bits * 10 + L)
    t = np.arange(23 * 32)[:, None] * (2 * np.pi / 37.0)
    sig = 12000 * np.sin(t + np.arange(L)) + rng.normal(0, 900, (23 * 32, L))
    pcm = np.clip(sig, -32768, 32767).astype(np.int16).reshape(23, 32, L)
    got = encode_batch_blocks(torch.from_numpy(pcm), bits=bits, search=search)
    want = jax_batch_encode(jnp.asarray(pcm), bits=bits, search=search)
    assert got.dtype == torch.uint8 and got.dim() == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _write_wav(path, pcm, rate=44100):
    pcm = np.asarray(pcm, np.int16)
    path.write_bytes(
        dump_riff_header(pcm.size * 2, rate, pcm.shape[1]) + pcm.tobytes()
    )


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    rng = np.random.default_rng(21)
    src = tmp_path_factory.mktemp("wavs") / "src"
    src.mkdir()
    cases = {}
    for i, (channels, frames) in enumerate(
        [(1, 333), (2, 333), (2, 64), (1, 512), (2, 300), (1, 40)]
    ):
        t = np.arange(frames)[:, None] * (2 * np.pi / (29.0 + i))
        sig = 11000 * np.sin(t) + rng.normal(0, 1500, (frames, channels))
        pcm = np.clip(sig, -32768, 32767).astype(np.int16)
        _write_wav(src / f"f{i}.wav", pcm)
        cases[f"f{i}"] = pcm
    (src / "junk.wav").write_bytes(b"not a wav")
    return src, cases


def _xa_outputs(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.xa"))}


@pytest.mark.parametrize("search,bits", [(True, 6), (False, 6), (True, 4),
                                         (False, 8)])
def test_encode_corpus_matches_jax(tmp_path, wavs, search, bits):
    src, cases = wavs
    kw = dict(bits=bits, search=search, batch_files=2, bucket_granularity=4)
    res = tcorpus.encode_corpus(src, tmp_path / "t", device=CPU, **kw)
    want = jcorpus.encode_corpus(src, tmp_path / "j", **kw)
    assert _counts(res) == _counts(want)
    got = _xa_outputs(tmp_path / "t")
    assert got == _xa_outputs(tmp_path / "j")
    assert list(res.failed) == [str(src / "junk.wav")]
    for name, pcm in cases.items():
        assert got[f"{name}.xa"] == encode_pcm(pcm, 44100, bits,
                                               search=search, device=CPU)
    again = tcorpus.encode_corpus(src, tmp_path / "t", device=CPU, **kw)
    assert again.converted == 0 and again.skipped == len(cases)
    assert (tmp_path / "t" / ".bjxa-encode-manifest-0.jsonl").exists()


def test_encode_corpus_explicit_paths_and_truncated(tmp_path, wavs):
    src, _cases = wavs
    short = tmp_path / "short.wav"
    short.write_bytes((src / "f3.wav").read_bytes()[:-8])
    paths = [src / "f2.wav", short, src / "f0.wav"]
    kw = dict(bits=6, search=False)
    res = tcorpus.encode_corpus(paths, tmp_path / "t", device=CPU, **kw)
    want = jcorpus.encode_corpus(paths, tmp_path / "j", **kw)
    assert _counts(res) == _counts(want)
    assert res.failed[str(short)] == "truncated PCM payload"
    assert _xa_outputs(tmp_path / "t") == _xa_outputs(tmp_path / "j")


@pytest.mark.parametrize("how", ["vanish", "shrink", "shrink_huge", "huge"])
def test_encode_corpus_file_changes_and_oversized(tmp_path, wavs,
                                                  monkeypatch, how):
    """Staging-time vanish or shrink degrades per file; oversized WAVs
    encode through the segmented route with bjxa_tpu's bytes and
    failures."""
    src, _cases = wavs
    work = tmp_path / "src"
    shutil.copytree(src, work)
    target = work / "f1.wav"
    if how in ("shrink_huge", "huge"):
        monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "1")
    real_open = builtins.open
    results = []
    for run, out in ((tcorpus.encode_corpus, tmp_path / "t"),
                     (jcorpus.encode_corpus, tmp_path / "j")):
        fake = {"vanish": _VanishingOpen(real_open, target),
                "huge": real_open}.get(
            how, _ShrinkingOpen(real_open, target, drop=100)
        )
        monkeypatch.setattr(builtins, "open", fake)
        kw = {"device": CPU} if run is tcorpus.encode_corpus else {}
        results.append(run(work, out, bits=6, search=False,
                           bucket_granularity=4, **kw))
        monkeypatch.setattr(builtins, "open", real_open)
    res, want = results
    assert _counts(res) == _counts(want)
    assert _xa_outputs(tmp_path / "t") == _xa_outputs(tmp_path / "j")
    assert (str(target) in res.failed) == (how != "huge")
    assert not list((tmp_path / "t").glob("*.tmp"))


def test_corpus_round_trip(tmp_path, wavs):
    """encode_corpus then decode_corpus gives back the search's own
    reconstruction: the decode of each XA the encode wrote."""
    src, cases = wavs
    tcorpus.encode_corpus(src, tmp_path / "xa", device=CPU, bits=8,
                          bucket_granularity=4)
    res = tcorpus.decode_corpus(tmp_path / "xa", tmp_path / "wav",
                                device=CPU, bucket_granularity=4)
    assert res.converted == len(cases) and not res.failed
    for name in cases:
        xa = (tmp_path / "xa" / f"{name}.xa").read_bytes()
        assert (tmp_path / "wav" / f"{name}.wav").read_bytes() == xa_to_wav(
            xa, device=CPU
        )
