"""Sequence-parallel single-stream ENCODE of the PyTorch port against
:mod:`bjxa_tpu`, on the CPU: the boundary-state ring composed with the
greedy 80-profile search
(:func:`bjxa_tpu_torch.parallel.sharded.encode_file_sharded`) against the
JAX package's ring -- packed blocks, carried end state and round count,
exactly -- and through every layer it is wired into: ``api.encode_pcm``,
``iter_encode_segments`` (whole and truncated) and ``encode --devices``.

JAX runs on its 8 virtual CPU devices; the port on ``[cpu] * n`` meshes.
The mirror of ``tests/test_sp_encode.py``.
"""

import io

import jax
import numpy as np
import pytest
import torch

from bjxa_tpu.parallel.mesh import make_mesh as jmake_mesh
from bjxa_tpu.parallel.sharded import encode_file_sharded as jencode
from bjxa_tpu_torch import dump_riff_header
from bjxa_tpu_torch import cli as tcli
from bjxa_tpu_torch.ops.encode import iter_encode_segments
from bjxa_tpu_torch.parallel.mesh import make_mesh
from bjxa_tpu_torch.parallel.sharded import encode_file_sharded
from test_torch_cli import run_cli

CPU = torch.device("cpu")
NAMES = ("sp", "_")


def music(rng, nblocks, channels, amp=12000):
    """Tonal signal + noise: exercises real filter-profile choices."""
    t = np.linspace(0, 40 * np.pi, nblocks * 32 * channels)
    pcm = amp * np.sin(t) + rng.integers(-3000, 3000, t.size)
    return pcm.astype(np.int32).reshape(nblocks, 32, channels)


def meshes(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return (jmake_mesh(devs[:n], dp=n, sp=1, axis_names=NAMES),
            make_mesh([CPU] * n, dp=n, sp=1, axis_names=NAMES))


@pytest.mark.parametrize(
    "channels,bits,nblocks,n",
    [(2, 6, 200, 8), (1, 4, 97, 3), (2, 8, 256, 2)],
)
def test_encode_file_sharded_matches(channels, bits, nblocks, n):
    rng = np.random.default_rng(nblocks + bits)
    pcm = music(rng, nblocks, channels)
    state = rng.integers(-200, 200, (channels, 2)).astype(np.int32)
    jm, tm = meshes(n)
    want = jencode(pcm, state, bits=bits, mesh=jm, local_chunks=3)
    got = encode_file_sharded(pcm, state, bits=bits, mesh=tm, local_chunks=3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32
    assert got[2] == want[2] and 1 <= got[2] <= n


def test_encode_file_sharded_b_total_trim():
    """Bucket-padded input: outputs trim to b_total and the carried state
    reads after the last REAL block, not the pad."""
    rng = np.random.default_rng(5)
    B, pad_to = 90, 128
    pcm = music(rng, pad_to, 2)
    pcm[B:] = 0  # bucket pad blocks
    state = np.zeros((2, 2), np.int32)
    jm, tm = meshes(8)
    want = jencode(pcm, state, bits=6, mesh=jm, local_chunks=2, b_total=B)
    got = encode_file_sharded(pcm, state, bits=6, mesh=tm, local_chunks=2,
                              b_total=B)
    assert got[0].shape == (B, 2, 25)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]
    with pytest.raises(ValueError):
        encode_file_sharded(pcm, state, bits=6, mesh=tm, b_total=0)


@pytest.fixture(scope="module")
def stream():
    """A stereo stream of 150 blocks less 7 frames, and the JAX package's
    XA image of it (the single-device search, which its own tests hold
    equal to its ring)."""
    from bjxa_tpu.api import encode_pcm as jencode_pcm

    samples = 150 * 32 - 7
    rng = np.random.default_rng(11)
    pcm = music(rng, 150, 2, amp=9000).reshape(-1, 2)[:samples]
    pcm = pcm.astype(np.int16)
    return pcm, jencode_pcm(pcm, 44100, 6)


@pytest.fixture(scope="module")
def sp_mesh():
    return make_mesh([CPU] * 8, dp=8, sp=1, axis_names=NAMES)


def test_encode_pcm_mesh_byte_identity(stream, sp_mesh):
    from bjxa_tpu_torch.api import encode_pcm

    pcm, want = stream
    assert encode_pcm(pcm, 44100, 6, device=CPU, mesh=sp_mesh,
                      sp_min_blocks=64) == want
    # below the threshold the mesh is ignored (the single-device path)
    assert encode_pcm(pcm, 44100, 6, device=CPU, mesh=sp_mesh) == want


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "truncated"])
def test_iter_encode_segments_mesh(stream, sp_mesh, cut):
    """Segmented encode over the ring: the one-shot bytes with the search
    state carried exactly across segments; a truncated stream yields its
    whole-block prefix, then EOFError."""
    pcm, want = stream
    C = 2
    body = pcm.astype("<i2").tobytes()
    if cut:
        body = body[: (64 * 32 + 11) * 2 * C]  # 64 whole blocks + a part
        want = want[: 32 + 64 * 25 * C]
    got = []
    with pytest.raises(EOFError) if cut else _nothing():
        for part in iter_encode_segments(
            io.BytesIO(body).read, C, pcm.shape[0], bits=6, search=True,
            device=CPU, segment_blocks=48, mesh=sp_mesh,
        ):
            got.append(part)
    assert b"".join(got) == want[32:]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cli_encode_devices(stream, monkeypatch):
    """``encode --devices 8`` with eight CPU entries: the segmented ring
    encode emits the JAX package's bytes."""
    pcm, want = stream
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.delenv("BJXA_DEVICES", raising=False)
    monkeypatch.setattr(tcli, "_local_devices", lambda: [CPU] * 8)
    wav = dump_riff_header(pcm.nbytes, 44100, 2) + pcm.astype(
        "<i2").tobytes()
    code, out, err = run_cli(
        tcli.main, ["encode", "--devices", "8", "--segment-blocks", "48",
                    "-", "-"], stdin=wav)
    assert (code, err) == (0, "")
    assert out == want
