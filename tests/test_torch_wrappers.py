"""The port's channel-major decode wrappers (``decode_arrays_fixpoint``,
``fixpoint_core``, ``fixpoint_core_fused``, ``decode_batch``) against their
:mod:`bjxa_tpu.ops.decode` twins on the CPU; ``clear_compiled_caches``; and
an AST walk that shows no module of the port, nor ``chip_smoke.py``,
imports JAX or :mod:`bjxa_tpu`.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bjxa_tpu.ops as jops
import bjxa_tpu_torch
from bjxa_tpu.ops import decode as jdecode
from bjxa_tpu_torch import ops as tops
from bjxa_tpu_torch.ops import decode as tdecode
from bjxa_tpu_torch.ops.inflate import inflate_blocks

REPO = pathlib.Path(__file__).resolve().parent.parent


def channel_blocks(rng, shape, bits, bad=None):
    """Seeded raw blocks ``uint8[*shape, 4*bits+1]`` with valid profiles;
    ``bad`` indexes one block whose profile factor is invalid."""
    raw = rng.integers(0, 256, size=(*shape, 4 * bits + 1), dtype=np.uint8)
    raw[..., 0] = (rng.integers(0, 5, size=shape) << 4
                   | rng.integers(0, 13, size=shape))
    if bad is not None:
        raw[bad + (0,)] = 0x6C
    return raw


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g == int(w)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("blocks,chunks", [(37, 4), (5, 1)])
def test_decode_arrays_fixpoint_matches_jax(bits, channels, blocks, chunks):
    """The CPU route (inflate, then :func:`fixpoint_core`) and the raw-bytes
    route (:func:`fixpoint_core_fused`, the card's) both equal the JAX
    package's decode, which on the CPU is ``fixpoint_core`` over
    ``inflate_blocks``: frames, end state, validity and rounds."""
    rng = np.random.default_rng(100 * bits + 10 * channels + blocks)
    raw = channel_blocks(rng, (channels, blocks), bits,
                         bad=(channels - 1, blocks // 2))
    state = rng.integers(-(2**15), 2**15, size=(channels, 2)).astype(np.int32)
    want = jdecode.decode_arrays_fixpoint(jnp.asarray(raw), jnp.asarray(state),
                                          bits=bits, num_chunks=chunks)
    b, s = torch.from_numpy(raw), torch.from_numpy(state)
    assert_same(tops.decode_arrays_fixpoint(b, s, bits=bits,
                                            num_chunks=chunks), want)
    assert_same(tdecode.fixpoint_core_fused(b, s, chunks, bits=bits), want)
    profiles, samples = inflate_blocks(b, bits)
    assert_same(tdecode.fixpoint_core(profiles, samples, s, chunks), want)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_decode_batch_matches_jax(bits, channels):
    rng = np.random.default_rng(7 * bits + channels)
    raw = channel_blocks(rng, (5, channels, 19), bits, bad=(3, 0, 11))
    state = rng.integers(-(2**15), 2**15,
                         size=(5, channels, 2)).astype(np.int32)
    want = jdecode.decode_batch(jnp.asarray(raw), jnp.asarray(state),
                                bits=bits)
    got = tops.decode_batch(torch.from_numpy(raw), torch.from_numpy(state),
                            bits=bits)
    assert_same(got, want)


def test_ops_exports_match_jax():
    """``ops`` exports the two channel-major conveniences the JAX
    package's ``ops`` does."""
    for name in ("decode_arrays_fixpoint", "decode_batch"):
        assert name in jops.__all__ and name in tops.__all__
        assert getattr(tops, name) is getattr(tdecode, name)


def test_clear_compiled_caches_keeps_results():
    """The caches go, CUDA stays uninitialised on a CPU run, and the next
    decode gives the same bytes."""
    from bjxa_tpu_torch import xa_to_wav
    from test_torch_codec import make_xa

    xa = make_xa(np.random.default_rng(3), 6, 2, 32 * 300 - 7)
    before = xa_to_wav(xa, device="cpu")
    cuda_was = torch.cuda.is_initialized()
    bjxa_tpu_torch.clear_compiled_caches()
    bjxa_tpu_torch.clear_compiled_caches(trim_malloc=False)
    assert torch.cuda.is_initialized() == cuda_was
    assert xa_to_wav(xa, device="cpu") == before
    assert "clear_compiled_caches" in bjxa_tpu_torch.__all__


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    return {n.split(".")[0] for n in names}


def test_port_imports_no_jax():
    """No module of the port and not ``chip_smoke.py`` imports ``jax`` or
    ``bjxa_tpu``, at any depth of its code."""
    files = sorted((REPO / "bjxa_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert REPO / "bjxa_tpu_torch" / "codec.py" in files
    assert REPO / "bjxa_tpu_torch" / "native" / "abi.py" in files
    bad = {str(p.relative_to(REPO)): sorted(_imports(p) & {"jax",
                                                           "bjxa_tpu"})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
