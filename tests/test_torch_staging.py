"""The whole-file encode's reused host buffers (``ops/encode.host_buffer``),
on the CPU against the JAX package (their page-locked form on the card is
tested in ``test_torch_cuda.py``, which imports no JAX).

``wav_to_xa`` copies the PCM body once into the calling thread's staging
buffer and, on a card, reads the packed blocks back into its readback
buffer; both grow to the largest call so far and are reused.  Every call
must still give the JAX package's bytes, whatever ran before it on the
thread, and whatever runs beside it on another.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import bjxa_tpu.api as japi
from bjxa_tpu_torch import api, dump_riff_header, load_pcm
from bjxa_tpu_torch.errors import BjxaBufferError
from bjxa_tpu_torch.ops import encode

#: (channels, bits, frames) of a run of calls: growing, shrinking, both
#: routes of the search (under and over 64 blocks), ragged last blocks.
RUN = [(1, 6, 70 * 32), (2, 8, 200 * 32 - 7), (1, 4, 20 * 32 + 1),
       (2, 6, 130 * 32 - 16), (2, 4, 10 * 32 + 5), (1, 8, 150 * 32)]


def _pcm(frames: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None]
    sig = 12000 * np.sin(t / (5.0 + 1.3 * np.arange(channels)))
    sig += rng.normal(0, 3000, size=(frames, channels))
    return np.clip(sig, -32768, 32767).astype(np.int16)


def _wav(frames: int, channels: int, seed: int, rate: int = 44100) -> bytes:
    pcm = _pcm(frames, channels, seed)
    return dump_riff_header(pcm.size * 2, rate, channels) + pcm.astype(
        "<i2").tobytes()


def _run_case(i: int):
    channels, bits, frames = RUN[i]
    return _wav(frames, channels, seed=i), bits


_JAX: dict = {}


def _jax(i: int) -> bytes:
    """The JAX package's image of call ``i`` of :data:`RUN` (once)."""
    if i not in _JAX:
        wav, bits = _run_case(i)
        _JAX[i] = japi.wav_to_xa(wav, bits)
    return _JAX[i]


def _on_thread(work):
    """``work()`` on a thread of its own (its buffers start empty); its
    result, or its exception raised here."""
    out = {}

    def body():
        try:
            out["value"] = work()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_song_shaped_stream_at_the_chunk_cap(monkeypatch):
    """A stereo 6-bit song cut to 3,232 blocks and a half, its chunk count
    forced to 32 so that each chunk holds ~101 blocks, as a 5-minute song
    at the 4,096-chunk cap does: the JAX package's bytes, and no block the
    benchmark's plain reference judges wrong."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from xabench import reference as ref

    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "32")
    frames = 3232 * 32 + 16
    assert encode.pick_encode_chunks(3233, 2) == 32
    assert -(-3233 // 32) == 102 and 3233 / 32 > 101
    wav = _wav(frames, 2, seed=20)
    got = api.wav_to_xa(wav, 6, device="cpu")
    assert got == japi.wav_to_xa(wav, 6)
    pcm = torch.from_numpy(_pcm(frames, 2, seed=20))
    assert ref.judge_encoded([got], [pcm], [44100], 6) == [0]


def test_buffers_reused_over_growing_and_shrinking_calls():
    """A run of calls of growing and shrinking sizes, mono and stereo, 4/6/8
    bits, on one thread: each image is the JAX package's, an earlier image
    is unchanged after later calls, and the staging buffer grows only to
    the largest call so far, then is reused as it is."""

    def work():
        images, sizes, ptrs = [], [], []
        stage = encode.host_buffer("staging", "cpu")
        for i in range(len(RUN)):
            wav, bits = _run_case(i)
            images.append(api.wav_to_xa(wav, bits, device="cpu"))
            sizes.append(stage.data.numel())
            ptrs.append(stage.data.data_ptr())
        # encode_pcm with an array stages through the same buffer
        pcm = _pcm(RUN[1][2], 2, seed=1)
        again = api.encode_pcm(pcm, 44100, RUN[1][1], device="cpu")
        return images, sizes, ptrs, stage.data.data_ptr(), again

    images, sizes, ptrs, last_ptr, again = _on_thread(work)
    copies = [bytes(bytearray(im)) for im in images]
    padded = [2 * channels * -(-frames // 32) * 32
              for channels, _, frames in RUN]
    assert sizes == list(np.maximum.accumulate(padded))
    for a, b, s, t in zip(ptrs, ptrs[1:], sizes, sizes[1:]):
        assert (a == b) == (s == t)
    assert last_ptr == ptrs[-1]
    for i, image in enumerate(images):
        assert type(image) is bytes
        assert image == copies[i] == _jax(i), i
    assert again == images[1]


def test_two_threads_at_once(monkeypatch):
    """Two threads calling ``wav_to_xa`` at once, each over its own run of
    shapes, their body copies split over the one pool of copy threads:
    each call's bytes are the JAX package's."""
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", 4096)
    want = {i: _jax(i) for i in range(len(RUN))}
    go = threading.Barrier(2, timeout=60)
    got = {0: [], 1: []}

    def work(k):
        go.wait()
        for i in (range(len(RUN)) if k == 0 else reversed(range(len(RUN)))):
            wav, bits = _run_case(i)
            got[k].append((i, api.wav_to_xa(wav, bits, device="cpu")))

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for k in (0, 1):
        assert len(got[k]) == len(RUN)
        for i, image in got[k]:
            assert image == want[i], (k, i)


def test_load_pcm_into_out():
    """``load_pcm(out=)`` fills and returns ``out``: the values of the one
    that makes its own array, and its errors, also with ``out``."""
    pcm = _pcm(97, 2, seed=3)
    raw = pcm.astype("<i2").tobytes()
    buf = np.full((100, 2), 7, np.int16)
    out = buf[:97]
    got = load_pcm(memoryview(raw), 2, out=out)
    assert got is out
    np.testing.assert_array_equal(got, load_pcm(raw, 2))
    np.testing.assert_array_equal(buf[97:], 7)
    for bad in (b"", raw[:-1]):
        with pytest.raises(BjxaBufferError):
            load_pcm(bad, 2, out=buf[:97])


def test_a_failed_call_leaves_the_thread_able_to_encode(monkeypatch):
    """A call that fails after staging its PCM (here in the search) leaves
    the thread's buffers usable: the next call's bytes are the JAX
    package's."""
    wav, bits = _run_case(3)
    real = api.encode_stream_blocks
    calls = []

    def fail_once(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("the search failed")
        return real(*args, **kw)

    monkeypatch.setattr(api, "encode_stream_blocks", fail_once)

    def work():
        with pytest.raises(RuntimeError):
            api.wav_to_xa(wav, bits, device="cpu")
        return api.wav_to_xa(wav, bits, device="cpu")

    assert _on_thread(work) == _jax(3)
    assert len(calls) == 2


@pytest.mark.parametrize("rows,channels", [(1001, 2), (3, 1), (4096, 1)])
def test_copy_into_splits_a_large_copy_over_threads(monkeypatch, rows,
                                                    channels):
    """Above its size, a copy runs in slices on the pool's threads and
    gives ``np.copyto``'s result; fewer rows than threads stay whole."""
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", 64)
    monkeypatch.setattr(hostcopy, "THREADS", 4)
    src = _pcm(rows, channels, seed=rows)
    dst = np.zeros_like(src)
    used = []
    real = hostcopy._executor
    monkeypatch.setattr(hostcopy, "_executor",
                        lambda: used.append(1) or real())
    hostcopy.copy_into(dst, src)
    np.testing.assert_array_equal(dst, src)
    assert used == ([] if rows < 4 else [1])


def test_copy_into_raises_what_a_slice_raised(monkeypatch):
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", 64)
    monkeypatch.setattr(hostcopy, "THREADS", 4)
    dst = np.zeros((400, 2), np.int16)
    dst.flags.writeable = False
    with pytest.raises(ValueError):
        hostcopy.copy_into(dst, _pcm(400, 2, seed=1))


def test_copy_pool_made_again_in_another_process(monkeypatch):
    """A process that is not the one that made the pool (a forked child,
    where the pool's threads do not exist) makes its own."""
    from bjxa_tpu_torch.utils import hostcopy

    first = hostcopy._executor()
    assert hostcopy._executor() is first
    pid = hostcopy.os.getpid()
    monkeypatch.setattr(hostcopy.os, "getpid", lambda: pid + 1)
    second = hostcopy._executor()
    assert second is not first and hostcopy._executor() is second


def test_copy_into_cuts_more_slices_than_threads(monkeypatch):
    """A split copy is cut into ``SLICES_PER_THREAD`` slices a thread, so
    a thread held up takes fewer; the slices cover every row once."""
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", 64)
    monkeypatch.setattr(hostcopy, "THREADS", 4)
    starts = []
    real = hostcopy._executor

    class Counted:
        def map(self, fn, it):
            it = list(it)
            starts.extend(it)
            return real().map(fn, it)

    monkeypatch.setattr(hostcopy, "_executor", Counted)
    src = _pcm(1001, 2, seed=5)
    dst = np.zeros_like(src)
    hostcopy.copy_into(dst, src)
    np.testing.assert_array_equal(dst, src)
    step = -(-1001 // (4 * hostcopy.SLICES_PER_THREAD))
    assert starts == list(range(0, 1001, step))
    assert len(starts) == 4 * hostcopy.SLICES_PER_THREAD


@pytest.mark.parametrize("split", [1 << 30, 64])
@pytest.mark.parametrize("n", [1, 4099, 100_003])
def test_joined_is_the_concatenation(monkeypatch, split, n):
    """``joined`` gives ``head + body``'s bytes as a new ``bytes`` object,
    whether its copy is split or not, and owns them: a later change to
    ``body`` leaves it as it was."""
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", split)
    monkeypatch.setattr(hostcopy, "THREADS", 4)
    head = bytes(range(32))
    body = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    body = body.reshape(-1, 1)
    want = head + body.tobytes()
    got = hostcopy.joined(head, body)
    assert type(got) is bytes
    assert got == want and hash(got) == hash(want)
    body[:] = 0
    assert got == want


def test_joined_raises_what_a_slice_raised(monkeypatch):
    from bjxa_tpu_torch.utils import hostcopy

    monkeypatch.setattr(hostcopy, "SPLIT_BYTES", 64)
    monkeypatch.setattr(hostcopy, "THREADS", 4)

    def fail(dst, src):
        raise ValueError("slice")

    monkeypatch.setattr(hostcopy, "copy_into", fail)
    with pytest.raises(ValueError):
        hostcopy.joined(b"h", np.zeros(4096, np.uint8))
