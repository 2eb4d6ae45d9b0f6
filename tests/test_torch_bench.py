"""The PyTorch port's measurement path on the CPU, at small sizes, exact.

The load and store variants' plain versions are held against the JAX
benchmark kernels themselves (``benchmarks/bench_load_variants.py``,
``bench_store_variants.py``), run in Pallas interpret mode; the load/store
bound and the ALU probe, whose TPU kernels are closures and cannot be
imported, against their contract written out in numpy.  The scripts' entry
points run at tiny ``BENCH_*`` sizes with ``BJXA_PLATFORM=cpu``.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bjxa_tpu_torch.benchmarks import (
    _variants,
    ablate,
    load_variants,
    roofline_bound,
    search_unroll,
    store_variants,
)
from bjxa_tpu_torch.benchmarks._common import NoDeviceError
from bjxa_tpu_torch.benchmarks import corpus as bcorpus
from bjxa_tpu_torch.benchmarks import encode as bencode
from bjxa_tpu_torch.benchmarks import segmented as bsegmented
from bjxa_tpu_torch.ops.cuda_decode import fused_decode_lanes_plain
from bjxa_tpu_torch.ops.decode import pack_words_from_lanes
from bjxa_tpu_torch.tools import encode_pack_falsify as tfalsify

REPO = pathlib.Path(__file__).resolve().parent.parent
TILES = dict(lane_tile=256, block_tile=4, sublanes=16)


@pytest.fixture(scope="module")
def jax_bench():
    """``bench_load_variants`` and ``bench_store_variants`` imported from
    ``benchmarks/`` with their ``pallas_call`` in interpret mode (they take
    no ``interpret`` argument of their own)."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    pl.pallas_call = functools.partial(real, interpret=True)
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import bench_load_variants
        import bench_store_variants

        yield bench_load_variants, bench_store_variants
    finally:
        pl.pallas_call = real
        sys.path.remove(str(REPO / "benchmarks"))
        for name in ("bench_load_variants", "bench_store_variants"):
            sys.modules.pop(name, None)


def lanes_case(seed, B=4, L=256):
    """Seeded 8-bit lane-major blocks (factors 0-7: 5 and up are invalid
    and still decode the same way on both sides) and int16-range states."""
    rng = np.random.default_rng(seed)
    blocks_t = rng.integers(0, 256, size=(B, 33, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (
        rng.integers(0, 8, size=(B, L)) << 4 | rng.integers(0, 16, (B, L))
    ).astype(np.uint8)
    state = rng.integers(-(2**15), 2**15, size=(L, 2)).astype(np.int32)
    return blocks_t, state


@pytest.mark.parametrize("store", ["i16", "pair"])
@pytest.mark.parametrize("seed", [1, 2])
def test_load_variant_plain_matches_jax_kernel(jax_bench, store, seed):
    jload, _ = jax_bench
    blocks_t, state = lanes_case(seed)
    jp, jw = jload.pack_words(jnp.asarray(blocks_t))
    prof, words = pack_words_from_lanes(torch.from_numpy(blocks_t), bits=8)
    np.testing.assert_array_equal(prof.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    want, want_end = jload.decode_w32(jp, jw, jnp.asarray(state), store=store,
                                      **TILES)
    got, got_end = load_variants.decode_w32(prof, words,
                                            torch.from_numpy(state),
                                            store=store)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(
        got.numpy(), want.reshape(want.shape[0], want.shape[1], -1))
    np.testing.assert_array_equal(got_end.numpy(), np.asarray(want_end))
    assert load_variants.LAUNCHES == 0  # the CPU never counts a launch


@pytest.mark.parametrize("mode", ["i16", "i32", "pair"])
@pytest.mark.parametrize("seed", [3, 4])
def test_store_variant_plain_matches_jax_kernel(jax_bench, mode, seed):
    _, jstore = jax_bench
    blocks_t, state = lanes_case(seed)
    want, want_end = jstore.decode_variant(
        jnp.asarray(blocks_t), jnp.asarray(state), bits=8, mode=mode, **TILES)
    got, got_end = store_variants.decode_variant(
        torch.from_numpy(blocks_t), torch.from_numpy(state), mode=mode)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(
        got.numpy(), want.reshape(want.shape[0], want.shape[1], -1))
    np.testing.assert_array_equal(got_end.numpy(), np.asarray(want_end))
    assert store_variants.LAUNCHES == 0


def test_pair_view_is_natural_sample_order():
    """The pair word's little-endian int16 view is the i16 output, and
    negative samples survive the packing (no sign smear into the high
    half)."""
    blocks_t, state = lanes_case(5, B=3, L=7)
    bt, st = torch.from_numpy(blocks_t), torch.from_numpy(state)
    pcm, end = fused_decode_lanes_plain(bt, st, bits=8)
    assert (pcm < 0).any() and (pcm > 0).any()
    pair, pair_end = store_variants.decode_variant(bt, st, mode="pair")
    assert pair.dtype == torch.int32 and tuple(pair.shape) == (3, 16, 7)
    assert torch.equal(_variants.pair_to_i16(pair), pcm)
    assert torch.equal(pair_end, end)
    want = (pcm.numpy()[:, 0::2].astype(np.int64) & 0xFFFF) | (
        (pcm.numpy()[:, 1::2].astype(np.int64) & 0xFFFF) << 16)
    np.testing.assert_array_equal(pair.numpy().view(np.uint32), want)


@pytest.mark.parametrize("call", [
    lambda bt, st: store_variants.decode_variant(bt, st, mode="i64"),
    lambda bt, st: load_variants.decode_w32(
        *pack_words_from_lanes(bt, bits=8), st, store="i32"),
], ids=["store_i64", "w32_i32"])
def test_variant_wrappers_refuse_unknown_forms(call):
    blocks_t, state = lanes_case(6, B=1, L=2)
    with pytest.raises(ValueError):
        call(torch.from_numpy(blocks_t), torch.from_numpy(state))


# -- kernel #9: the load/store bound, against its contract in numpy ----------


def null_contract(prof, words, state):
    """``_null_kernel`` of bench_roofline_bound.py, block by block, in
    numpy's wrapping int32: ``base = prof + sum(words)``, ``out[b, n] =
    int16(base + n)`` truncating, ``acc += base``; end row 0 = ``state[:, 0]
    + acc``, row 1 untouched."""
    B, W, L = words.shape
    out = np.zeros((B, 32, L), np.int16)
    acc = state[:, 0].copy()
    with np.errstate(over="ignore"):
        for b in range(B):
            base = prof[b].astype(np.int32)
            for w in range(W):
                base = base + words[b, w]
            for n in range(32):
                out[b, n] = (base + np.int32(n)).astype(np.int16)
            acc = acc + base
    return out, np.stack([acc, state[:, 1]], axis=-1)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("extreme", [False, True], ids=["random", "wrapping"])
def test_null_decode_plain_matches_contract(bits, extreme):
    rng = np.random.default_rng(bits + 10 * extreme)
    B, L = 5, 9
    prof = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    words = rng.integers(-(2**31), 2**31, size=(B, bits, L), dtype=np.int64)
    state = rng.integers(-(2**31), 2**31, size=(L, 2), dtype=np.int64)
    if extreme:  # sums that overflow int32 in both directions, base + n too
        words[:, :, 0::3] = 2**31 - 1
        words[:, :, 1::3] = -(2**31)
        words[0, :, 2] = 0
        words[0, 0, 2] = 2**31 - 5  # base + n crosses INT32_MAX
        state[0::2, 0] = 2**31 - 1
    words, state = words.astype(np.int32), state.astype(np.int32)
    want, want_end = null_contract(prof, words, state)
    before = roofline_bound.LAUNCHES
    got, got_end = roofline_bound.null_decode(
        torch.from_numpy(prof), torch.from_numpy(words),
        torch.from_numpy(state))
    assert roofline_bound.LAUNCHES == before
    assert got.dtype == torch.int16 and got_end.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_end.numpy(), want_end)


def test_words_traffic_counts_every_byte_once():
    # 8-bit headline shape: 33 B in and 64 B out per block and lane, plus
    # the states in and out
    assert roofline_bound.words_traffic(64, 32768, 8) == (
        64 * 32768 * (33 + 64) + 2 * 32768 * 8)


# -- kernel #11: the ALU probe, against its contract in numpy ----------------


def alu_contract(x, mix):
    """The probe kernel of tools/encode_pack_falsify.py in numpy, whose
    fixed-width integers wrap as the JAX dtypes do."""
    dt = x.dtype.type
    y = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(256):
            if mix == "full":
                y = (y * dt(3) + x) >> dt(2)
                y = np.clip(y + dt(1), -16384, 16383).astype(x.dtype)
            elif mix == "clip":
                y = y * dt(3) + x
                y = np.clip(y + dt(1), -16384, 16383).astype(x.dtype)
            else:
                y = y * dt(3) + x + dt(1)
    return y


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("mix", ["full", "clip", "muladd"])
def test_alu_mix_plain_matches_contract(dtype, mix):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(len(mix))
    x = rng.integers(info.min, info.max + 1, size=(6, 50)).astype(dtype)
    # wraparound cases: the extremes, and values whose y*3 + x overflows
    x[0, :6] = [info.max, info.min, info.max // 3 + 1, -1, 0, 16383]
    before = tfalsify.LAUNCHES
    got = tfalsify.alu_mix(torch.from_numpy(x), mix=mix)
    assert tfalsify.LAUNCHES == before
    assert got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), alu_contract(x, mix))
    if mix == "muladd":  # 256 unclipped steps do wrap: the cases bite
        assert np.abs(got.numpy().astype(np.int64)).max() > 16384


def test_alu_mix_refuses_other_types_and_mixes():
    x = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfalsify.alu_mix(x, mix="fma")
    with pytest.raises(TypeError):
        tfalsify.alu_mix(x.long(), mix="full")


def test_semantic_report_is_the_tools_copy(capsys):
    """The numpy half of the probe is a copy of tools/encode_pack_falsify.py
    (which imports no JAX at module level): same candidate errors, same
    report."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import encode_pack_falsify as jfalsify
    finally:
        sys.path.remove(str(REPO / "tools"))
    rng = np.random.default_rng(0)
    x = rng.integers(-30000, 30000, size=(32, 20))
    p0, p1 = rng.integers(-30000, 30000, size=(2, 20))
    for mode in ("exact", "sat16", "wrap16"):
        got = tfalsify.candidate_block(x, p0, p1, 6, 3, 5, mode)
        want = jfalsify.candidate_block(x, p0, p1, 6, 3, 5, mode)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    tfalsify.semantic_report(blocks=12, seed=1)
    ours = capsys.readouterr().out
    jfalsify.semantic_report(blocks=12, seed=1)
    assert ours == capsys.readouterr().out and "profile divergence" in ours


# -- the scripts' entry points, on the CPU at tiny sizes ---------------------


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    for name, value in {
        "BENCH_REPS": 1, "BENCH_LANES": 8, "BENCH_BLOCKS": 3,
        "BENCH_FILES": 4,
    }.items():
        monkeypatch.setenv(name, str(value))
    monkeypatch.delenv("BENCH_BITS", raising=False)


def test_roofline_bound_main(tiny_env, capsys):
    recs = roofline_bound.main()
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [r["bits"] for r in recs] == [4, 6, 8]
    for r in recs:
        assert r["metric"] == "loadstore_bound" and r["device"] == "cpu"
        assert r["unit"] == "Msamples/s" and r["lanes"] == 8
        assert r["value"] > 0 and r["gb_per_s"] >= 0


@pytest.mark.parametrize("mod,metric,variants", [
    (load_variants, "load_variant_rate",
     ["w32+i16", "w32+pair", "production words kernel",
      "production lanes kernel"]),
    (store_variants, "store_variant_rate", ["u8+i16", "u8+i32", "u8+pair"]),
    (ablate, "decode_ablation_rate", ["full", "states-only"]),
], ids=["load", "store", "ablate"])
def test_variant_scripts_main(tiny_env, capsys, mod, metric, variants):
    """Each script checks its variants against the production decode, then
    times them: one line a variant."""
    recs = mod.main()
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == recs
    assert [r["variant"] for r in recs] == variants
    assert all(r["metric"] == metric and r["device"] == "cpu"
               and r["value"] >= 0 and r["ms"] > 0 for r in recs)


def test_load_variants_check_catches_a_wrong_variant(tiny_env, monkeypatch):
    real = _variants.repack
    monkeypatch.setattr(
        _variants, "repack",
        lambda pcm, store: real(pcm + (store == "i16"), store))
    with pytest.raises(AssertionError, match="w32\\+i16"):
        load_variants.main()


def test_alu_probe_bench(tiny_env, monkeypatch, capsys):
    monkeypatch.setattr(tfalsify, "SHAPE", (3, 8))
    recs = tfalsify.bench_int16_vs_int32(reps=1)
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == recs
    rates = [r for r in recs if r["metric"] == "alu_mix_rate"]
    assert [(r["dtype"], r["mix"]) for r in rates] == [
        (d, m) for d in ("int32", "int16")
        for m in ("full", "clip", "muladd")]
    ratios = [r for r in recs if r["metric"] == "int16_over_int32_rate"]
    assert [r["mix"] for r in ratios] == ["full", "clip", "muladd"]
    assert all("no packed 16-bit integer multiply" in r["note"]
               and isinstance(r["pays"], bool) for r in ratios)


def test_encode_and_corpus_scripts(tiny_env, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BLOCKS", "20")
    monkeypatch.setenv("BENCH_FILES", "3")
    monkeypatch.setenv("BENCH_BATCH_FILES", "2")
    monkeypatch.setenv("BENCH_REPS", "2")
    enc = bencode.main()
    assert enc["metric"] == "encode_search_throughput" and enc["bits"] == 6
    assert (enc["blocks"], enc["lanes"]) == (20, 8)
    corp = bcorpus.main()
    assert corp["metric"] == "corpus_decode_files_per_s"
    assert corp["files"] == 3 and len(corp["runs_s"]) == 2
    assert corp["vs_baseline"] == pytest.approx(corp["value"] / 77.0,
                                                abs=1e-3)
    assert {"stage", "launch", "write"} <= set(corp["stage_ms"])
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_segmented_bench(tiny_env, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BLOCKS", "300")
    monkeypatch.setenv("BENCH_SEGMENT", "128")
    rec = bsegmented.main()
    assert rec["metric"] == "segmented_decode_rate"
    assert rec["segment_blocks"] == 128 and len(rec["runs_s"]) == 1
    assert rec["pcm_mb"] == pytest.approx((44 + 300 * 32 * 2 * 2) / 1e6,
                                          abs=0.06)
    assert rec["peak_rss_mb"] > 0
    assert json.loads(capsys.readouterr().out) == rec


@pytest.mark.parametrize("unroll", search_unroll.UNROLLS)
def test_search_unroll_variants_change_the_pragma_alone(unroll):
    """Each variant is the production search source with its sample loop's
    pragma changed, and unroll 1 is the production source itself."""
    prod = (search_unroll._build.CSRC / "encode_block.cuh").read_text()
    var = search_unroll.variant_source(unroll)
    pragma = "#pragma unroll" + ("" if unroll == 32 else f" {unroll}")
    loop = search_unroll.LOOP
    assert var.replace(loop.replace("#pragma unroll 1", pragma), loop) == prod
    assert (var == prod) == (unroll == 1)


def test_search_unroll_needs_the_card(tiny_env):
    with pytest.raises(NoDeviceError, match="needs the card"):
        search_unroll.main()


def _run_bench(env_extra, drop=()):
    env = dict(os.environ, PYTHONPATH=str(REPO), **env_extra)
    for name in drop:
        env.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", "bjxa_tpu_torch.bench"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


TINY_BENCH = {
    "BENCH_REPS": "1", "BENCH_FILES": "4", "BENCH_BLOCKS": "3",
    "BENCH_ENC_BLOCKS": "2", "BENCH_ENC_LANES": "8",
    "BENCH_CORPUS_FILES": "3", "BENCH_CORPUS_BLOCKS": "30",
    "BENCH_CORPUS_BATCH": "2",
}


def test_bench_module_prints_three_metrics_headline_last():
    res = _run_bench(dict(TINY_BENCH, BJXA_PLATFORM="cpu"))
    assert res.returncode == 0, res.stderr
    recs = [json.loads(s) for s in res.stdout.splitlines()]
    assert [r["metric"] for r in recs] == [
        "encode_search_throughput", "corpus_decode_files_per_s",
        "decode_throughput"]
    assert all(r["device"] == "cpu" for r in recs)
    head = recs[-1]
    assert head["unit"] == "Msamples/s" and head["lanes"] == 8
    assert head["vs_baseline"] == pytest.approx(head["value"] / 100.0,
                                                abs=0.01)
    only = _run_bench(dict(TINY_BENCH, BJXA_PLATFORM="cpu",
                           BENCH_SKIP_EXTRAS="1"))
    assert only.returncode == 0, only.stderr
    assert [json.loads(s)["metric"] for s in only.stdout.splitlines()] == [
        "decode_throughput"]


def test_mesh_flat_bench(tiny_env, monkeypatch, capsys):
    """The words and lanes paths of a one-device mesh, equal PCM, timed."""
    from bjxa_tpu_torch.benchmarks import mesh_flat

    monkeypatch.setenv("BENCH_BLOCKS", "40")
    monkeypatch.setenv("BENCH_REPS", "2")
    rec = mesh_flat.main()
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["metric"] == "mesh_batch_seconds" and rec["device"] == "cpu"
    assert rec["shape"] == "[40,33,8]" and len(rec["words_runs_s"]) == 2


def test_multihost_bench(tiny_env, monkeypatch, capsys):
    """Two gloo processes run the CLI corpus job; the totals of process 0's
    summary cover every file."""
    from bjxa_tpu_torch.benchmarks import multihost

    for name, value in {"BENCH_FILES": 3, "BENCH_SAMPLES": 700,
                        "BENCH_BATCH_FILES": 2, "BENCH_PROCS": "2"}.items():
        monkeypatch.setenv(name, str(value))
    rec = multihost.main()
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["summary"] == "converted 3 skipped 0 failed 0 samples 4200"
    assert set(rec["processes"]) == {"2"} and rec["device"] == "cpu"


def test_bench_module_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = _run_bench(TINY_BENCH, drop=("BJXA_PLATFORM",))
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA is not available" in res.stderr


def test_measurement_modules_import_no_jax():
    probe = (
        "import sys\n"
        "import bjxa_tpu_torch.bench\n"
        "from bjxa_tpu_torch.benchmarks import (ablate, corpus, encode,"
        " load_variants, mesh_flat, multihost, roofline_bound,"
        " search_unroll, segmented, store_variants)\n"
        "from bjxa_tpu_torch.tools import encode_pack_falsify\n"
        "from bjxa_tpu_torch.parallel import (distributed, mesh, pipeline,"
        " sharded)\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'bjxa_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
