"""The plain PyTorch versions of the two CUDA kernels against the JAX
package: its plain path and, in one small case each, its Pallas kernels in
interpret mode (the kernels the CUDA ones replace).  Exact comparison.

On a CPU tensor each wrapper runs its plain version and leaves its launch
counter alone; on a device with no kernel it raises (no fallback).  The
kernels themselves are compared with these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu.ops.filter import adpcm_filter_lanes, decode_lanes
from bjxa_tpu.ops.inflate import inflate_lanes
from bjxa_tpu.ops.pallas_decode import fused_decode_lanes as pallas_decode
from bjxa_tpu.ops.pallas_filter import adpcm_filter_pallas
from bjxa_tpu.ops.tables import GAIN_K0, GAIN_K1
from bjxa_tpu_torch.ops import cuda_decode, cuda_filter


def _lanes(bits, B, L, seed):
    """Raw lane-major blocks with profile factors 0-7 (>= 5 invalid) and
    states over all of int16."""
    rng = np.random.default_rng(seed)
    blocks_t = rng.integers(0, 256, size=(B, 4 * bits + 1, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (
        rng.integers(0, 8, size=(B, L)) << 4 | rng.integers(0, 16, (B, L))
    ).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return blocks_t, state


def _filter_case(B, L, seed):
    rng = np.random.default_rng(seed)
    samples = rng.integers(-(2**15), 2**15, size=(B, 32, L)).astype(np.int16)
    fac = rng.integers(0, 5, size=(B, L))
    k0 = GAIN_K0[fac].astype(np.int32)
    k1 = GAIN_K1[fac].astype(np.int32)
    shift = rng.integers(0, 16, size=(B, L)).astype(np.int32)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return samples, k0, k1, shift, state


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("with_output", [True, False])
def test_decode_plain_matches_jax_plain(bits, with_output):
    blocks_t, state = _lanes(bits, B=9, L=37, seed=bits)
    pcm, end = cuda_decode.fused_decode_lanes(
        torch.from_numpy(blocks_t), torch.from_numpy(state), bits=bits,
        with_output=with_output,
    )
    prof, samp = inflate_lanes(jnp.asarray(blocks_t), bits)
    jpcm, jend, _ = decode_lanes(
        prof, samp, jnp.asarray(state), with_output=with_output,
        use_pallas=False,
    )
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    if with_output:
        assert pcm.dtype == torch.int16
        np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))
    else:
        assert pcm is None


@pytest.mark.parametrize("with_output", [True, False])
def test_decode_plain_matches_pallas_interpret(with_output):
    blocks_t, state = _lanes(4, B=4, L=64, seed=21)
    pcm, end = cuda_decode.fused_decode_lanes(
        torch.from_numpy(blocks_t), torch.from_numpy(state), bits=4,
        with_output=with_output,
    )
    jpcm, jend = pallas_decode(
        jnp.asarray(blocks_t), jnp.asarray(state), bits=4, lane_tile=64,
        block_tile=4, sublanes=16, with_output=with_output, interpret=True,
    )
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    if with_output:
        np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))


@pytest.mark.parametrize("B,L", [(13, 1), (6, 2), (3, 50)])
@pytest.mark.parametrize("with_output", [True, False])
def test_filter_plain_matches_jax_plain(B, L, with_output):
    samples, k0, k1, shift, state = _filter_case(B, L, seed=B * L)
    pcm, end = cuda_filter.adpcm_filter_kernel(
        *(torch.from_numpy(a) for a in (samples, k0, k1, shift, state)),
        with_output=with_output,
    )
    ranged = samples.astype(np.int32) >> shift[:, None, :]
    jpcm, jend = adpcm_filter_lanes(
        jnp.asarray(ranged), jnp.asarray(k0), jnp.asarray(k1),
        jnp.asarray(state), with_output=with_output,
    )
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    if with_output:
        np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))
    else:
        assert pcm is None


@pytest.mark.parametrize("with_output", [True, False])
def test_filter_plain_matches_pallas_interpret(with_output):
    samples, k0, k1, shift, state = _filter_case(4, 64, seed=5)
    pcm, end = cuda_filter.adpcm_filter_kernel(
        *(torch.from_numpy(a) for a in (samples, k0, k1, shift, state)),
        with_output=with_output,
    )
    jpcm, jend = adpcm_filter_pallas(
        *(jnp.asarray(a) for a in (samples, k0, k1, shift, state)),
        lane_tile=64, block_tile=4, with_output=with_output, interpret=True,
    )
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    if with_output:
        np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))


def test_decode_lanes_kernel_twin_matches_decode_lanes():
    """The filter kernel's decode_lanes twin (plain on the CPU) equals the
    JAX decode_lanes, validity mask included."""
    blocks_t, state = _lanes(6, B=5, L=3, seed=8)
    prof, samp = inflate_lanes(jnp.asarray(blocks_t), 6)
    pcm, end, valid = cuda_filter.decode_lanes_kernel(
        torch.from_numpy(np.array(prof)), torch.from_numpy(np.array(samp)),
        torch.from_numpy(state),
    )
    jpcm, jend, jvalid = decode_lanes(
        prof, samp, jnp.asarray(state), use_pallas=False
    )
    for t, j in ((pcm, jpcm), (end, jend), (valid, jvalid)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cpu_tensors_never_launch(monkeypatch):
    monkeypatch.setattr(cuda_decode, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_filter, "LAUNCHES", 0)
    blocks_t, state = _lanes(8, B=2, L=3, seed=1)
    for wo in (True, False):
        cuda_decode.fused_decode_lanes(
            torch.from_numpy(blocks_t), torch.from_numpy(state), bits=8,
            with_output=wo,
        )
        cuda_filter.adpcm_filter_kernel(
            *(torch.from_numpy(a) for a in _filter_case(2, 3, seed=2)),
            with_output=wo,
        )
    assert cuda_decode.LAUNCHES == 0 and cuda_filter.LAUNCHES == 0


def test_no_kernel_device_raises():
    """A tensor on a device without a kernel raises; it never falls back
    to the plain version."""
    blocks_t = torch.zeros((1, 17, 4), dtype=torch.uint8, device="meta")
    state = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_decode.fused_decode_lanes(blocks_t, state, bits=4)
    args = [torch.zeros((1, 32, 4), dtype=torch.int16, device="meta")] + [
        torch.zeros((1, 4), dtype=torch.int32, device="meta")
    ] * 3 + [state]
    with pytest.raises(ValueError, match="no kernel"):
        cuda_filter.adpcm_filter_kernel(*args)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that refuses the sources raises and leaves no library
    behind; nothing falls back to the plain versions."""
    from bjxa_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    assert _build.library_path().parent == tmp_path
    with pytest.raises(_build.KernelBuildError, match="nvcc failed"):
        _build.build()
    assert not list(tmp_path.glob("*.so*"))
    with pytest.raises(RuntimeError, match="error 700"):
        _build.check_launch(700, "bjxa_decode_lanes")
    _build.check_launch(0, "bjxa_decode_lanes")
