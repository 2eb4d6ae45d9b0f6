"""The chunked schedule of the load/store variants kernel on the CPU, exact.

``csrc/decode_variants.cu`` runs the words kernel's chunk schedule with one
load or store policy swapped.  Its chunked plain versions
(``load_variants.decode_w32_chunked_plain``,
``store_variants.decode_variant_chunked_plain``) are held here against the
JAX benchmark kernels themselves (``benchmarks/bench_load_variants.py``,
``bench_store_variants.py``) in Pallas interpret mode, at every chunk count
and every instantiation, and their rounds against
``ops.chunking.fixpoint_states`` over an independent per-chunk decode.
``launch_variant``'s host side (K, Bc, scratch, grid) runs against a
stand-in library; the sources are checked to share one chunk body.  The
kernel itself is held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu_torch.benchmarks import (
    _variants,
    load_variants,
    store_variants,
    u8_ring,
)
from bjxa_tpu_torch.benchmarks._common import NoDeviceError
from bjxa_tpu_torch.ops import _build
from bjxa_tpu_torch.ops import cuda_decode_words as cdw
from bjxa_tpu_torch.ops.chunking import fixpoint_states, word_chunks
from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes_plain
from bjxa_tpu_torch.ops.decode import pack_words_from_lanes

from test_torch_bench import REPO, TILES, jax_bench, lanes_case  # noqa: F401

#: A multiple of the JAX kernels' block tile (4), that K = 2, 3, 7 and B
#: all divide into chunks with none empty: Bc = 14, 10, 4 and 1.
B = 28
L = 256  # the JAX kernels' lane tile
KS = (1, 2, 3, 7, B)
VARIANTS = (("w32", "i16"), ("w32", "pair"), ("u8", "i16"), ("u8", "i32"),
            ("u8", "pair"))


def _case(seed):
    """Seeded 8-bit blocks (factors 0-7, 5 and up invalid) and int16-range
    states, as numpy."""
    return lanes_case(seed, B=B, L=L)


@functools.cache
def _jax_out(jload_store, load, store, seed):
    """The JAX benchmark kernel of one instantiation, in interpret mode, as
    numpy ``(out [B, rows, L], end)``."""
    jload, jstore = jload_store
    blocks_t, state = _case(seed)
    if load == "w32":
        jp, jw = jload.pack_words(jnp.asarray(blocks_t))
        out, end = jload.decode_w32(jp, jw, jnp.asarray(state), store=store,
                                    **TILES)
    else:
        out, end = jstore.decode_variant(jnp.asarray(blocks_t),
                                         jnp.asarray(state), bits=8,
                                         mode=store, **TILES)
    out = np.asarray(out)
    return out.reshape(out.shape[0], out.shape[1], -1), np.asarray(end)


def _chunked_plain(load, store, blocks_t, state, chunks):
    bt, st = torch.from_numpy(blocks_t), torch.from_numpy(state)
    if load == "w32":
        prof, words = pack_words_from_lanes(bt, bits=8)
        return load_variants.decode_w32_chunked_plain(
            prof, words, st, store=store, chunks=chunks)
    return store_variants.decode_variant_chunked_plain(bt, st, mode=store,
                                                       chunks=chunks)


def _rounds_by_fixpoint_states(blocks_t, state, chunks):
    """The round count of the exact fixed point over the chunks, each chunk
    decoded on its own from its start (no padding, no lane folding)."""
    K, Bc = word_chunks(blocks_t.shape[0], chunks)
    if K == 1:
        return 0
    bt = torch.from_numpy(blocks_t)

    def run(states_flat, _with_output):
        ends = [fused_decode_lanes_plain(
            bt[k * Bc:(k + 1) * Bc].contiguous(),
            states_flat[k * L:(k + 1) * L].contiguous(), bits=8,
            with_output=False)[1] for k in range(K)]
        return None, torch.cat(ends)

    _starts, rounds = fixpoint_states(run, torch.from_numpy(state), K, L,
                                      max_iters=K)
    return rounds


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("load,store", VARIANTS)
def test_chunked_plain_matches_jax_kernel(jax_bench, load, store, K):
    """Output, end state and dtype exactly, at every K; the rounds equal
    the words kernel's chunked plain version's and stay within 1..K."""
    blocks_t, state = _case(7)
    want, want_end = _jax_out(jax_bench, load, store, 7)
    out, end, rounds = _chunked_plain(load, store, blocks_t, state, K)
    assert out.numpy().dtype == want.dtype
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(end.numpy(), want_end)
    bt = torch.from_numpy(blocks_t)
    prof, words = pack_words_from_lanes(bt, bits=8)
    _p, _e, words_rounds = cdw.fused_decode_words_chunked_plain(
        prof, words, torch.from_numpy(state), bits=8, chunks=K)
    assert rounds == words_rounds
    assert (rounds == 0) if K == 1 else (1 <= rounds <= K)
    assert (load_variants.LAUNCHES, store_variants.LAUNCHES) == (0, 0)


@pytest.mark.parametrize("K", (2, 7, B))
@pytest.mark.parametrize("seed", (1, 2))
def test_chunked_rounds_equal_fixpoint_states(K, seed):
    """Random blocks, and (seed 2) the slow-merging stream: factor 4,
    range 12, payload bytes near zero, whose starts take more than two
    rounds to settle at K = B."""
    blocks_t, state = _case(seed)
    if seed == 2:
        rng = np.random.default_rng(seed)
        blocks_t[:, 1:, :] = rng.choice(
            np.array([0x00, 0x11, 0xEE, 0xFF], np.uint8), size=(B, 32, L))
        blocks_t[:, 0, :] = 4 << 4 | 12
    want = _rounds_by_fixpoint_states(blocks_t, state, K)
    for load, store in (("w32", "pair"), ("u8", "i32")):
        assert _chunked_plain(load, store, blocks_t, state, K)[2] == want
    if seed == 2 and K == B:
        assert want > 2


def test_chunked_plain_ragged_chunks_and_lanes():
    """A prime block count (a short last chunk) at ragged lane counts,
    against the sequential plain versions."""
    for L_ in (1, 3, 33):
        blocks_t, state = lanes_case(L_, B=23, L=L_)
        bt, st = torch.from_numpy(blocks_t), torch.from_numpy(state)
        prof, words = pack_words_from_lanes(bt, bits=8)
        for K in (1, 2, 7, 23):
            for store in load_variants.STORES:
                out, end, _r = load_variants.decode_w32_chunked_plain(
                    prof, words, st, store=store, chunks=K)
                sout, send = load_variants.decode_w32_plain(prof, words, st,
                                                            store=store)
                assert torch.equal(out, sout) and torch.equal(end, send)
            for mode in store_variants.MODES:
                out, end, _r = store_variants.decode_variant_chunked_plain(
                    bt, st, mode=mode, chunks=K)
                sout, send = store_variants.decode_variant_plain(bt, st,
                                                                 mode=mode)
                assert torch.equal(out, sout) and torch.equal(end, send)


def test_chunked_wrappers_refuse_the_cpu():
    """The kernel forms launch or raise: a CPU tensor never takes a plain
    version through them."""
    blocks_t, state = (torch.from_numpy(a) for a in lanes_case(1, B=4, L=8))
    prof, words = pack_words_from_lanes(blocks_t, bits=8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        store_variants.decode_variant_chunked(blocks_t, state, mode="i16")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        load_variants.decode_w32_chunked(prof, words, state, store="pair")


class _FakeLibrary:
    """Stands in for the kernel library: records the launch's arguments."""

    def __init__(self):
        self.calls = []

    def bjxa_decode_variant_occupancy(self, load, store, device):
        return 3

    def bjxa_decode_variant(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("Bb,Ll,sms", [
    (64, 32768, 132),  # the scripts' shape: K = 1
    (20736, 32, 132),  # a corpus batch: K = 1296
    (512, 32, 132),  # short lanes: 8 blocks a chunk at the least
    (512, 32, 114),  # another card's SM count
    (15, 32, 132),  # too short for two chunks
])
@pytest.mark.parametrize("load,store", (("w32", "pair"), ("u8", "i32")))
def test_launch_variant_picks_the_words_kernels_chunks(monkeypatch, load,
                                                       store, Bb, Ll, sms):
    """``launch_variant`` launches at ``pick_word_chunks``' K for the card's
    SM count, with ``word_chunks``' Bc, the words kernel's scratch size and
    a grid of one thread an item, at most the occupancy times the SMs."""
    from bjxa_tpu_torch.ops import cuda_decode

    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=sms))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    cuda_decode.occupancy.cache_clear()
    try:
        blocks_t = torch.zeros((Bb, 33, Ll), dtype=torch.uint8)
        state = torch.zeros((Ll, 2), dtype=torch.int32)
        if load == "w32":
            prof, words = pack_words_from_lanes(blocks_t, bits=8)
            args = (prof, words, state)
        else:
            args = (blocks_t, None, state)
        out, end, rounds = _variants.launch_variant("t", load, store, *args)
    finally:
        cuda_decode.occupancy.cache_clear()
    (call,) = fake.calls
    K, Bc = word_chunks(Bb, cdw.pick_word_chunks(Bb, Ll, sms))
    assert call[6:12] == (Bb, Ll, K, Bc, _variants.LOADS[load],
                          _variants.STORES[store][0])
    assert call[12] == min(-(-K * Ll // 128), 3 * sms)
    code, rows, dtype = _variants.STORES[store]
    assert out.dtype == dtype and tuple(out.shape) == (Bb, rows, Ll)
    assert tuple(end.shape) == (Ll, 2) and rounds.numel() == 1
    assert rounds._base.numel() == 4 + (4 * K * Ll if K > 1 else 0)


#: A ring loop of its own: the cp.async primitives, or the chunk fixed
#: point's round loop.
_OWN_LOOPS = re.compile(r"__pipeline_|while \(changed")


@pytest.mark.parametrize("source", ["decode_words.cu", "decode_variants.cu",
                                    "loadstore_bound.cu"])
def test_words_kernels_share_one_chunk_body(source):
    """The words kernel, its variants and its measured bound include the
    one chunk body and the one schedule, and copy neither loop."""
    src = (_build.CSRC / source).read_text()
    assert '#include "decode_chunk.cuh"' in src
    assert '#include "chunk_fixpoint.cuh"' in src
    assert "chunk_fixpoint<" in src
    assert not _OWN_LOOPS.search(src)
    body = (_build.CSRC / "decode_chunk.cuh").read_text()
    assert body.count("__pipeline_wait_prior") == 1
    assert re.search(r"\b(run_chunk|run_item)<|\bring_blocks\(", src)


@pytest.mark.parametrize("form,stages", u8_ring.FORMS)
def test_u8_ring_forms_change_the_load_alone(form, stages):
    """Each form of the u8 ablation is the production source with its u8
    load line and stage count changed, ``null`` with the decode step
    replaced too and ``thread`` with its load policy added to the chunk
    body (production has none); the first form is the production source
    itself."""
    srcs = u8_ring.variant_sources(form, stages)
    var = srcs["decode_variants.cu"]
    load = "Thread" if form == "thread" else "Warp"
    back = var.replace(u8_ring.FORM.replace("Warp", load), u8_ring.FORM)
    back = back.replace(u8_ring.STAGES.replace("4", str(stages)),
                        u8_ring.STAGES)
    assert back == (_build.CSRC / "decode_variants.cu").read_text()
    assert set(srcs) == ({"decode_variants.cu", "decode_chunk.cuh"}
                         if form in ("null", "thread")
                         else {"decode_variants.cu"})
    if form in ("null", "thread"):
        body = srcs["decode_chunk.cuh"]
        if form == "null":
            body = body.replace(u8_ring.NULL_STEP, u8_ring.STEP)
        else:
            assert "LoadU8Thread" not in (_build.CSRC /
                                          "decode_chunk.cuh").read_text()
            body = body.replace(u8_ring.THREAD_LOAD, "")
        assert body == (_build.CSRC / "decode_chunk.cuh").read_text()
    changed = any(text != (_build.CSRC / name).read_text()
                  for name, text in srcs.items())
    assert changed != ((form, stages) == u8_ring.FORMS[0])


def test_u8_ring_needs_the_card(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    with pytest.raises(NoDeviceError, match="needs the card"):
        u8_ring.main()
