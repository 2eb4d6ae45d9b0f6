"""The PyTorch port's corpus engine on a device mesh against
:mod:`bjxa_tpu.parallel.corpus`, on the CPU: ``decode_corpus(mesh=)`` and
``encode_corpus(mesh=)`` (each batch's lanes sharded over the mesh's data
axis) and an oversized file's segments sharded over the same devices as a
sequence-parallel ring.  The mirror of the mesh cases of
``tests/test_corpus.py``.

JAX runs on its 8 virtual CPU devices; the port on ``[cpu] * n`` meshes.
Exact comparison: output bytes, failures and manifests.
"""

import numpy as np
import torch

from bjxa_tpu_torch.parallel import sharded as tsharded
from test_torch_parallel import _xa_stream, jmesh, tmesh

CPU = torch.device("cpu")


def _corpus_records(d):
    import json

    return sorted(
        (r["key"], r["out"].rsplit("/", 1)[-1], r["samples"])
        for m in d.glob(".bjxa-*manifest-*.jsonl")
        for r in map(json.loads, m.read_text().splitlines())
    )


def _files(d, pattern):
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


def test_decode_corpus_on_mesh(tmp_path):
    """``decode_corpus(mesh=)``: every batch's lanes over 8 entries (the
    words decode a shard; 4 lanes a batch, padded), the JAX package's WAVs,
    failures and manifest."""
    from bjxa_tpu.parallel.corpus import decode_corpus as jdecode_corpus
    from bjxa_tpu_torch.parallel.corpus import decode_corpus

    rng = np.random.default_rng(41)
    src = tmp_path / "src"
    src.mkdir()
    for i, (bits, ch, nb) in enumerate([(6, 2, 30), (6, 2, 41), (6, 2, 35),
                                        (6, 2, 17), (6, 2, 40)]):
        payload, fmt = _xa_stream(rng, bits, ch, nb, ((5, -9), (0, 3)))
        from bjxa_tpu_torch import dump_xa_header

        img = bytearray(dump_xa_header(fmt) + payload)
        if i == 4:
            img[32 + 9 * fmt.block_size_xa] = 0x7F  # an invalid profile
        (src / f"f{i}.xa").write_bytes(bytes(img))
    (src / "junk.xa").write_bytes(b"nope")
    calls = []
    orig = tsharded.decode_corpus_sharded_words

    def spy(*a, **k):
        calls.append(k["mesh"].shape["dp"])
        return orig(*a, **k)

    tsharded.decode_corpus_sharded_words = spy
    try:
        got = decode_corpus(src, tmp_path / "t", device=CPU, batch_files=2,
                            bucket_granularity=16, mesh=tmesh(8))
    finally:
        tsharded.decode_corpus_sharded_words = orig
    want = jdecode_corpus(src, tmp_path / "j", batch_files=2,
                          bucket_granularity=16, mesh=jmesh(8))
    assert calls and set(calls) == {8}
    assert (got.converted, got.skipped) == (want.converted, want.skipped)
    assert got.converted == 4 and sorted(got.failed) == sorted(want.failed)
    assert _files(tmp_path / "t", "*.wav") == _files(tmp_path / "j", "*.wav")
    assert _corpus_records(tmp_path / "t") == _corpus_records(tmp_path / "j")


def test_encode_corpus_on_mesh(tmp_path):
    """``encode_corpus(mesh=)``: the lane-sharded flat encode, the JAX
    package's XA files and manifest."""
    from bjxa_tpu.parallel.corpus import encode_corpus as jencode_corpus
    from bjxa_tpu_torch import dump_pcm, dump_riff_header
    from bjxa_tpu_torch.parallel.corpus import encode_corpus

    rng = np.random.default_rng(42)
    src = tmp_path / "wav"
    src.mkdir()
    for i, (ch, frames) in enumerate([(1, 500), (2, 321), (2, 40), (1, 99)]):
        pcm = rng.integers(-20000, 20000, size=(frames, ch)).astype(np.int16)
        (src / f"w{i}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, ch) + dump_pcm(pcm))
    got = encode_corpus(src, tmp_path / "t", device=CPU, bits=6,
                        search=False, bucket_granularity=4, mesh=tmesh(3))
    want = jencode_corpus(src, tmp_path / "j", bits=6, search=False,
                          bucket_granularity=4, mesh=jmesh(3))
    assert got.converted == want.converted == 4 and not got.failed
    assert _files(tmp_path / "t", "*.xa") == _files(tmp_path / "j", "*.xa")
    assert _corpus_records(tmp_path / "t") == _corpus_records(tmp_path / "j")


def test_corpus_huge_uses_sp_ring_on_mesh(tmp_path, monkeypatch):
    """With a dp mesh, an oversized file's segments shard over the same
    devices rebuilt as an sp ring: the JAX package's WAV."""
    from bjxa_tpu.api import xa_to_wav as jxa_to_wav
    from bjxa_tpu_torch import dump_xa_header
    from bjxa_tpu_torch.parallel.corpus import decode_corpus

    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "1")
    rng = np.random.default_rng(71)
    payload, fmt = _xa_stream(rng, 6, 2, 300, ((40, 1), (-7, 2)))
    xa = dump_xa_header(fmt) + payload
    src = tmp_path / "src"
    src.mkdir()
    (src / "h.xa").write_bytes(xa)
    calls = []
    orig = tsharded.decode_file_sharded

    def spy(*a, **k):
        calls.append(k["mesh"].shape["sp"])
        return orig(*a, **k)

    monkeypatch.setattr(tsharded, "decode_file_sharded", spy)
    res = decode_corpus(src, tmp_path / "out", device=CPU, mesh=tmesh(8))
    assert res.converted == 1, res.failed
    assert calls and set(calls) == {8}
    assert (tmp_path / "out" / "h.wav").read_bytes() == jxa_to_wav(xa)
