"""The PyTorch port's scaling layer against :mod:`bjxa_tpu.parallel`, on the
CPU: the sequence-parallel ring decode, the data-parallel corpus entry
points, the ``mesh=`` branches of ``decode_bytes`` and
``iter_decode_segments``, and the transcode step.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port on
meshes that name the CPU once per device (``[cpu] * n``), its counterpart
of those virtual devices.  Every comparison is exact -- PCM, end states,
validity and the ring's round count -- except the transcode step's float32
mean-squared error (rel 1e-6: its reduction order is unspecified).
"""

import io
import itertools

import jax
import numpy as np
import pytest
import torch

from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu.parallel import make_mesh as jmake_mesh
from bjxa_tpu.parallel import sharded as jsharded
from bjxa_tpu_torch.format.xa import XAFormat
from bjxa_tpu_torch.ops import decode as tdecode
from bjxa_tpu_torch.parallel import sharded as tsharded
from bjxa_tpu_torch.parallel.mesh import dp_sharding, make_mesh

CPU = torch.device("cpu")


def random_blocks(rng, channels, nblocks, bits):
    """Channel-major raw blocks with valid profiles (tests/test_parallel.py)."""
    size = 4 * bits + 1
    blocks = rng.integers(0, 256, size=(channels, nblocks, size),
                          dtype=np.uint8)
    factor = rng.integers(0, 5, size=(channels, nblocks))
    shift = rng.integers(0, 4, size=(channels, nblocks))
    blocks[:, :, 0] = (factor << 4 | shift).astype(np.uint8)
    return blocks


def jmesh(n, axis_names=("dp", "sp")):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jmake_mesh(devs[:n], dp=n, sp=1, axis_names=axis_names)


def tmesh(n, axis_names=("dp", "sp")):
    return make_mesh([CPU] * n, dp=n, sp=1, axis_names=axis_names)


def lane_major(blocks):
    """``uint8[N, C, B, S]`` -> ``uint8[B, S, N*C]``."""
    N, C, B, S = blocks.shape
    return np.ascontiguousarray(blocks.transpose(2, 3, 0, 1)
                                .reshape(B, S, N * C))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_shape_and_devices():
    mesh = make_mesh([CPU] * 6, sp=2)
    assert mesh.shape == {"dp": 3, "sp": 2}
    assert mesh.devices.shape == (3, 2)
    assert list(mesh.devices.flat) == [CPU] * 6
    assert mesh.axis_devices("sp") == [CPU] * 2
    with pytest.raises(ValueError, match="mesh 4x2 != 6 devices"):
        make_mesh([CPU] * 6, dp=4, sp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    parts = dp_sharding(mesh, 2).shard(np.arange(12).reshape(6, 2))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    with pytest.raises(ValueError):
        dp_sharding(mesh, 2).shard(np.zeros((5, 2)))


# ---------------------------------------------------------------------------
# sequence parallel: the ring decode
# ---------------------------------------------------------------------------

# every bits x channels x nblocks case once, n cycling over 1, 2, 3, 8
SP_CASES = [
    (n, bits, channels, nblocks)
    for n, (bits, channels, nblocks) in zip(
        itertools.cycle((1, 2, 3, 8)),
        itertools.product((4, 6, 8), (1, 2), (256, 301)),
    )
]


@pytest.mark.parametrize("n,bits,channels,nblocks", SP_CASES)
def test_file_sp_matches(n, bits, channels, nblocks):
    """``decode_file_sharded`` from a random entry state, with an invalid
    profile mid-stream: the PCM, validity and round count of
    :func:`bjxa_tpu.parallel.sharded.decode_file_sharded`."""
    rng = np.random.default_rng(nblocks * 7 + bits * 3 + channels + n)
    blocks = random_blocks(rng, channels, nblocks, bits)
    blocks[channels - 1, nblocks // 2, 0] = 0x73  # factor 7: invalid
    state = rng.integers(-1000, 1000, size=(channels, 2)).astype(np.int32)
    names = ("sp", "unused")
    want = jsharded.decode_file_sharded(
        blocks, state, bits=bits, mesh=jmesh(n, names), axis="sp",
        local_chunks=4)
    got = tsharded.decode_file_sharded(
        blocks, state, bits=bits, mesh=tmesh(n, names), axis="sp",
        local_chunks=4)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0].dtype == np.int16 and got[1].dtype == np.bool_
    assert not got[1].all()
    assert got[2] == want[2] and 1 <= got[2] <= n


def test_file_sp_end_state_matches():
    """``fixpoint_lanes_end_state``, the ring's per-shard step, gives the
    JAX package's end state."""
    rng = np.random.default_rng(3)
    K, C, Bc, bits = 4, 2, 9, 6
    blocks_t = np.ascontiguousarray(
        random_blocks(rng, K * C, Bc, bits).transpose(1, 2, 0))
    state = rng.integers(-500, 500, size=(C, 2)).astype(np.int32)
    want = jdecode.fixpoint_lanes_end_state(
        jax.numpy.asarray(blocks_t), jax.numpy.asarray(state), K, C,
        bits=bits, fused=False)
    got = tdecode.fixpoint_lanes_end_state(
        torch.from_numpy(blocks_t), torch.from_numpy(state), K, C, bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _xa_stream(rng, bits, channels, nblocks, state):
    blocks = random_blocks(rng, channels, nblocks, bits)
    payload = np.ascontiguousarray(blocks.transpose(1, 0, 2)).tobytes()
    fmt = XAFormat(
        data_len=len(payload), samples=nblocks * 32 - 5, samples_rate=44100,
        bits=bits, channels=channels, initial_state=state,
    )
    return payload, fmt


def _jfmt(fmt):
    from bjxa_tpu.format.xa import XAFormat as JFormat

    return JFormat(**{f: getattr(fmt, f) for f in (
        "data_len", "samples", "samples_rate", "bits", "channels",
        "initial_state")})


def test_decode_bytes_sp_mesh():
    """``decode_bytes(mesh=)`` takes the ring for a long stream and the
    single-device path below ``sp_min_blocks``: both bit-exact with the
    JAX package; an invalid profile raises its message."""
    rng = np.random.default_rng(77)
    payload, fmt = _xa_stream(rng, 6, 2, 96, ((11, -7), (3, 5)))
    want = jdecode.decode_bytes(payload, _jfmt(fmt))
    mesh = tmesh(8, ("sp", "unused"))
    calls = []
    orig = tsharded.decode_file_sharded

    def spy(*a, **k):
        calls.append(k["mesh"])
        return orig(*a, **k)

    try:
        tsharded.decode_file_sharded = spy
        got = tdecode.decode_bytes(payload, fmt, device=CPU, mesh=mesh,
                                   sp_min_blocks=64)
        assert calls == [mesh]
        short = tdecode.decode_bytes(payload, fmt, device=CPU, mesh=mesh,
                                     sp_min_blocks=10**6)
        one = tdecode.decode_bytes(payload, fmt, device=CPU,
                                   mesh=tmesh(1, ("sp", "unused")),
                                   sp_min_blocks=64)
        assert len(calls) == 1  # a one-device sp axis stays single-device
    finally:
        tsharded.decode_file_sharded = orig
    for out in (got, short, one):
        np.testing.assert_array_equal(out, want)

    bad = bytearray(payload)
    bad[70 * fmt.block_size_xa + fmt.block_size] = 0x5F
    with pytest.raises(Exception) as jerr:
        jdecode.decode_bytes(bytes(bad), _jfmt(fmt))
    with pytest.raises(Exception) as terr:
        tdecode.decode_bytes(bytes(bad), fmt, device=CPU, mesh=mesh,
                             sp_min_blocks=64)
    assert str(terr.value) == str(jerr.value) == (
        "invalid block profile factor in block 70 channel 1")


def test_iter_decode_segments_sp_mesh():
    """Segments of a stream each sharded over the ring: the JAX package's
    frames; a bad profile in a later segment reports its absolute block
    after the valid prefix."""
    rng = np.random.default_rng(5)
    payload, fmt = _xa_stream(rng, 4, 2, 250, ((100, -3), (-40, 7)))
    want = np.concatenate(list(jdecode.iter_decode_segments(
        io.BytesIO(payload).read, _jfmt(fmt), segment_blocks=96)))
    mesh = tmesh(3, ("sp", "_"))
    got = np.concatenate(list(tdecode.iter_decode_segments(
        io.BytesIO(payload).read, fmt, device=CPU, segment_blocks=96,
        mesh=mesh)))
    np.testing.assert_array_equal(got, want)

    bad = bytearray(payload)
    bad_block = 2 * 96 + 7
    bad[bad_block * fmt.block_size_xa] = 0xF0
    out = []
    with pytest.raises(Exception) as e:
        for part in tdecode.iter_decode_segments(
            io.BytesIO(bytes(bad)).read, fmt, device=CPU, segment_blocks=96,
            mesh=mesh,
        ):
            out.append(part)
    assert f"block {bad_block} channel 0" in str(e.value)
    np.testing.assert_array_equal(np.concatenate(out),
                                  want[: bad_block * 32])


# ---------------------------------------------------------------------------
# data parallel: the corpus entry points (lane counts the axis does not
# divide, padded and trimmed)
# ---------------------------------------------------------------------------


def test_corpus_dp_matches():
    """``decode_corpus_sharded`` (the filter path over ``[N, C, B, S]``)
    on a 3-device axis; N must divide, as in the JAX package."""
    rng = np.random.default_rng(0)
    bits, C, B, N = 6, 2, 25, 6
    blocks = np.stack([random_blocks(rng, C, B, bits) for _ in range(N)])
    states = rng.integers(-300, 300, size=(N, C, 2)).astype(np.int32)
    want = jsharded.decode_corpus_sharded(blocks, states, bits=bits,
                                          mesh=jmesh(3))
    got = tsharded.decode_corpus_sharded(blocks, states, bits=bits,
                                         mesh=tmesh(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tsharded.decode_corpus_sharded(blocks[:5], states[:5], bits=bits,
                                       mesh=tmesh(3))


def test_corpus_lanes_sharded_matches():
    rng = np.random.default_rng(21)
    bits, C, B, N = 4, 2, 16, 7  # 14 lanes -> pads to 16
    blocks_t = lane_major(
        np.stack([random_blocks(rng, C, B, bits) for _ in range(N)]))
    blocks_t[5, 0, 3] = 0x6A  # an invalid profile
    states = rng.integers(-50, 50, size=(N * C, 2)).astype(np.int32)
    want = jsharded.decode_corpus_sharded_lanes(blocks_t, states, bits=bits,
                                                mesh=jmesh(8))
    got = tsharded.decode_corpus_sharded_lanes(blocks_t, states, bits=bits,
                                               mesh=tmesh(8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2].all()


@pytest.mark.parametrize("n", [8, 1])
def test_corpus_words_flat_sharded_matches(n):
    """The packed-words decode, flat per shard, reassembled; n = 1 is the
    one-device mesh the CLI builds on a one-card host
    (``test_corpus_words_one_device_mesh`` of the JAX tests)."""
    rng = np.random.default_rng(5 + n)
    bits, C, B, N = 6, 2, 40, 11  # 22 lanes -> pads to 24 at n = 8
    blocks_t = lane_major(
        np.stack([random_blocks(rng, C, B, bits) for _ in range(N)]))
    states = rng.integers(-100, 100, size=(N * C, 2)).astype(np.int32)
    prof, words = jdecode.words_from_blocks_host(blocks_t, bits)
    jflat, jre = jsharded.decode_corpus_sharded_words(
        prof, words, states, bits=bits, mesh=jmesh(n))
    shards, reassemble = tsharded.decode_corpus_sharded_words(
        prof, words, states, bits=bits, mesh=tmesh(n))
    assert len(shards) == n and all(s.dim() == 1 for s in shards)
    flat = tsharded.host_flat(shards)
    np.testing.assert_array_equal(flat, np.asarray(jflat))
    np.testing.assert_array_equal(reassemble(flat), jre(np.asarray(jflat)))


@pytest.mark.parametrize("search", [False, True])
def test_encode_corpus_sharded_matches(search):
    """The lane-sharded corpus encode, 3-D and flat, search and
    truncation, against the JAX package's."""
    rng = np.random.default_rng(6)
    B, L, n = (3, 5, 3) if search else (12, 10, 8)
    pcm = rng.integers(-30000, 30000, size=(B, 32, L)).astype(np.int16)
    states = rng.integers(-900, 900, size=(L, 2)).astype(np.int32)
    want = np.asarray(jsharded.encode_corpus_sharded_lanes(
        pcm, states, bits=6, search=search, mesh=jmesh(n)))
    got = tsharded.encode_corpus_sharded_lanes(
        pcm, states, bits=6, search=search, mesh=tmesh(n))
    np.testing.assert_array_equal(got.numpy(), want)
    shards, reassemble = tsharded.encode_corpus_sharded_flat(
        pcm, states, bits=6, search=search, mesh=tmesh(n))
    assert len(shards) == n
    np.testing.assert_array_equal(reassemble(tsharded.host_flat(shards)),
                                  want)


# ---------------------------------------------------------------------------
# the transcode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["xa", "random"])
def test_transcode_step_on_mesh(source):
    """Decode -> 80-profile re-encode -> global MSE over a (dp, cp) mesh:
    the JAX package's blocks and MSE.  Re-encoding an XA-quantized signal
    reproduces it exactly (MSE 0); random blocks give a positive MSE."""
    import jax.numpy as jnp

    from bjxa_tpu.parallel.mesh import make_mesh as jmm
    from bjxa_tpu.parallel.pipeline import corpus_shardings as jcs
    from bjxa_tpu.parallel.pipeline import transcode_step as jstep
    from bjxa_tpu_torch.api import encode_pcm
    from bjxa_tpu_torch.parallel.pipeline import (
        corpus_shardings,
        transcode_step,
    )

    rng = np.random.default_rng(17)
    bits, C, B, N = 6, 2, 5, 4
    if source == "xa":
        blocks = np.stack([
            np.frombuffer(encode_pcm(
                rng.integers(-20000, 20000, size=(B * 32, C)).astype(
                    np.int16), 44100, bits, device=CPU)[32:], np.uint8,
            ).reshape(B, C, -1).transpose(1, 0, 2)
            for _ in range(N)
        ])
    else:
        blocks = np.stack([random_blocks(rng, C, B, bits) for _ in range(N)])
    states = np.zeros((N, C, 2), np.int32)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jm = jmm(jax.devices(), dp=4, sp=2, axis_names=("dp", "cp"))
    blk_sh, st_sh = jcs(jm)
    jxa, jmse = jstep(jax.device_put(jnp.asarray(blocks), blk_sh),
                      jax.device_put(jnp.asarray(states), st_sh), bits=bits)
    mesh = make_mesh([CPU] * 8, dp=4, sp=2, axis_names=("dp", "cp"))
    xa, mse = transcode_step(blocks, states, bits=bits,
                             sharding=corpus_shardings(mesh))
    assert xa.shape == (N, B, C, 4 * bits + 1)
    np.testing.assert_array_equal(xa, np.asarray(jxa))
    assert mse.dtype == np.float32
    np.testing.assert_allclose(mse, float(jmse), rtol=1e-6)
    one, one_mse = transcode_step(blocks, states, bits=bits)
    np.testing.assert_array_equal(one, xa)
    np.testing.assert_allclose(one_mse, mse, rtol=1e-6)
    if source == "xa":
        np.testing.assert_array_equal(xa, blocks.transpose(0, 2, 1, 3))
        assert float(mse) == 0.0
    else:
        assert float(mse) > 0.0
