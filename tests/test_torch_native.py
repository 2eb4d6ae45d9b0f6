"""The port's native host library (``bjxa_tpu_torch/native``): its decode,
truncation encode and search encode against the numpy oracle
(:mod:`bjxa_tpu_torch.ops.numpy_ref`), the port's plain search and the JAX
package's copy of the library; the ``BJXA_NO_NATIVE`` gate; a failed build
that raises; and an UndefinedBehaviorSanitizer build of the port's copy,
which must report nothing and give the ``-O3`` build's bytes.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bjxa_tpu.native as jnative
import bjxa_tpu_torch.native as native
from bjxa_tpu_torch import XAFormat, codec, dump_xa_header
from bjxa_tpu_torch.ops import numpy_ref
from bjxa_tpu_torch.ops.deflate import deflate_blocks
from bjxa_tpu_torch.ops.encode import encode_search
from bjxa_tpu_torch.ops.tables import block_size_for_bits

NATIVE = pathlib.Path(native.__file__).parent


def random_effective_blocks(rng, nblocks, channels, bits):
    size = block_size_for_bits(bits)
    blocks = rng.integers(0, 256, size=(nblocks, channels, size),
                          dtype=np.uint8)
    factor = rng.integers(0, 5, size=(nblocks, channels))
    shift = rng.integers(0, 16, size=(nblocks, channels))
    blocks[:, :, 0] = (factor << 4 | shift).astype(np.uint8)
    return blocks


def loud_signal(rng, frames, channels):
    """Full-scale square waves plus noise: residuals of both signs and of
    the largest sizes, so the search shifts large negative values."""
    t = np.arange(frames)[:, None]
    sq = np.where((t // (7 + 5 * np.arange(channels))) % 2, 32767, -32768)
    sig = sq + rng.normal(0, 6000, size=(frames, channels))
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_decode_matches_oracle(bits, channels):
    rng = np.random.default_rng(bits + channels)
    blocks = random_effective_blocks(rng, 40, channels, bits)
    state = rng.integers(-5000, 5000, size=(channels, 2)).astype(np.int32)
    ref_state = state.copy()
    pcm, done = native.decode_blocks(blocks, bits, state)
    assert done == 40
    for c in range(channels):
        ref = numpy_ref.decode_channel(blocks[:, c, :], bits, ref_state[c])
        np.testing.assert_array_equal(pcm[:, c], ref)
    np.testing.assert_array_equal(state, ref_state)
    lanes_state = state.copy()
    lanes_state[:] = rng.integers(-5000, 5000, size=(channels, 2))
    want_state = lanes_state.copy()
    np.testing.assert_array_equal(
        native.decode_blocks(blocks, bits, lanes_state)[0],
        numpy_ref.decode_lanes_fixpoint(blocks, bits, want_state))
    np.testing.assert_array_equal(lanes_state, want_state)


def test_decode_stops_at_invalid_profile():
    rng = np.random.default_rng(0)
    blocks = random_effective_blocks(rng, 10, 2, 8)
    blocks[4, 1, 0] = 0xFF
    state = np.zeros((2, 2), np.int32)
    pcm, done = native.decode_blocks(blocks, 8, state)
    assert done == 4
    ref = np.zeros((2, 2), np.int32)
    want = numpy_ref.decode_lanes_fixpoint(blocks[:4], 8, ref)
    np.testing.assert_array_equal(pcm[: 4 * 32], want)
    # the left channel of the bad block advanced, the right did not
    numpy_ref.decode_channel(blocks[4:5, 0, :], 8, ref[0])
    np.testing.assert_array_equal(state, ref)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_truncate_matches_oracle(bits, channels):
    rng = np.random.default_rng(3 * bits + channels)
    pcm = rng.integers(-32768, 32768, size=(32 * 13, channels)).astype(
        np.int16)
    out = native.encode_blocks(pcm, bits, np.zeros((channels, 2), np.int32),
                               search=False)
    for b in range(13):
        for c in range(channels):
            prof, payload = numpy_ref.encode_truncate_block(
                pcm[b * 32:(b + 1) * 32, c], bits)
            assert out[b, c, 0] == prof
            np.testing.assert_array_equal(out[b, c, 1:], payload)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_search_matches_plain_search_and_jax_library(bits, channels):
    """The host search picks the plain search's profiles, bytes and end
    state (same f32 error accumulation, same tie breaks), and the JAX
    package's library (the shifts before the fix) gives the same bytes."""
    rng = np.random.default_rng(7 * bits + channels)
    sig = loud_signal(rng, 32 * 17, channels)
    state = rng.integers(-3000, 3000, size=(channels, 2)).astype(np.int32)
    st_native, st_jax = state.copy(), state.copy()
    out = native.encode_blocks(sig, bits, st_native, search=True)

    profiles, coded, _recon, end = encode_search(
        torch.from_numpy(sig.reshape(-1, 32, channels)),
        torch.from_numpy(state), bits=bits)
    plain = deflate_blocks(profiles, coded.transpose(1, 2), bits).numpy()
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(st_native, end.numpy())

    np.testing.assert_array_equal(
        out, jnative.encode_blocks(sig, bits, st_jax, search=True))
    np.testing.assert_array_equal(st_native, st_jax)
    blocks = random_effective_blocks(rng, 31, channels, bits)
    a, b = state.copy(), state.copy()
    np.testing.assert_array_equal(native.decode_blocks(blocks, bits, a)[0],
                                  jnative.decode_blocks(blocks, bits, b)[0])
    np.testing.assert_array_equal(a, b)


def test_no_native_gate(monkeypatch):
    """``BJXA_NO_NATIVE`` turns the library off: ``lib()`` is None, the
    bindings refuse, and the codec takes its numpy path."""
    assert native.available()
    monkeypatch.setenv("BJXA_NO_NATIVE", "1")
    assert native.lib() is None and not native.available()
    with pytest.raises(RuntimeError, match="BJXA_NO_NATIVE"):
        native.decode_blocks(np.zeros((1, 1, 33), np.uint8), 8,
                             np.zeros((1, 2), np.int32))
    from bjxa_tpu_torch.native import abi

    assert abi.lib() is None and abi.cli_path() is None
    with pytest.raises(RuntimeError, match="BJXA_NO_NATIVE"):
        abi.install("unused")

    def refuse(*_a, **_k):
        raise AssertionError("native path taken")

    monkeypatch.setattr(native, "decode_blocks", refuse)
    monkeypatch.setattr(native, "encode_blocks", refuse)
    dec = codec.Decoder()
    dec.parse_header(dump_xa_header(XAFormat(
        data_len=66, samples=32, samples_rate=44100, bits=8, channels=2,
        initial_state=((0, 0), (0, 0)))))
    assert dec.decode(bytes(66)).shape == (32, 2)
    monkeypatch.delenv("BJXA_NO_NATIVE")
    assert native.lib() is not None


@pytest.mark.parametrize("fault", ["missing_compiler", "bad_source"])
def test_failed_build_raises(monkeypatch, tmp_path, fault):
    """A compiler that is missing or refuses the source raises with its
    message; nothing falls back and no library is left behind."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", tmp_path / "libbjxa_host.so")
    if fault == "missing_compiler":
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        match = "no-such-compiler"
    else:
        src = tmp_path / "broken.cc"
        src.write_text("int broken( {\n")
        monkeypatch.setattr(native, "_SRC", src)
        match = "broken.cc"
    with pytest.raises(native.NativeBuildError, match=match):
        native.lib()
    with pytest.raises(native.NativeBuildError):
        native.available()
    assert not (tmp_path / "libbjxa_host.so").exists()
    assert not list(tmp_path.glob(".*.tmp"))


def test_concurrent_builds_do_not_collide(tmp_path):
    """Workers that build at once write files of their own and move them
    into place: every process loads a whole library."""
    env = dict(os.environ, PYTHONPATH=str(NATIVE.parents[1]))
    probe = (
        "import pathlib, sys\n"
        "import bjxa_tpu_torch.native as n\n"
        "n._SO = pathlib.Path(sys.argv[1])\n"
        "assert n.lib().bjxa_host_abi_version() == 1\n"
    )
    so = tmp_path / "libbjxa_host.so"
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(so)], env=env)
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    assert so.exists() and not list(tmp_path.glob(".*.tmp"))


UBSAN_DRIVER = r"""
#include <cstdio>
#include <cstdint>
#include <vector>
#include "bjxa_host.cc"

// Full-scale square waves plus noise from a fixed LCG: the search shifts
// large negative residuals left.  Writes every output to stdout.
int main() {
  uint32_t seed = 12345u;
  auto next = [&]() { seed = seed * 1664525u + 1013904223u; return seed; };
  const uint32_t nblocks = 97;
  for (uint32_t channels = 1; channels <= 2; channels++) {
    for (uint32_t bits = 4; bits <= 8; bits += 2) {
      std::vector<int16_t> pcm(nblocks * 32 * channels);
      for (size_t i = 0; i < pcm.size(); i++) {
        const int32_t sq = ((i / channels / (5 + bits)) % 2) ? 32767 : -32768;
        int32_t v = sq + static_cast<int32_t>(next() % 24001u) - 12000;
        pcm[i] = static_cast<int16_t>(v < -32768 ? -32768
                                      : v > 32767 ? 32767 : v);
      }
      const uint32_t bsz = bits * 4 + 1;
      std::vector<uint8_t> xa(nblocks * channels * bsz);
      int32_t state[4] = {-32768, 32767, 12345, -23456};
      if (bjxa_host_encode_search(pcm.data(), nblocks, channels, bits,
                                  state, xa.data()) != 0) return 2;
      fwrite(xa.data(), 1, xa.size(), stdout);
      fwrite(state, sizeof state, 1, stdout);
      std::vector<int16_t> out(nblocks * 32 * channels);
      int32_t dstate[4] = {-32768, 32767, 12345, -23456};
      uint32_t done = 0;
      if (bjxa_host_decode_blocks(xa.data(), nblocks, channels, bits, dstate,
                                  out.data(), &done) != 0) return 3;
      fwrite(out.data(), 2, out.size(), stdout);
      if (bjxa_host_encode_truncate(pcm.data(), nblocks, channels, bits,
                                    xa.data()) != 0) return 4;
      fwrite(xa.data(), 1, xa.size(), stdout);
    }
  }
  return 0;
}
"""


def _ubsan_available(tmp_path) -> bool:
    probe = tmp_path / "probe.cc"
    probe.write_text("int main() { return 0; }\n")
    res = subprocess.run(
        [os.environ.get("CXX", "g++"), "-fsanitize=undefined", str(probe),
         "-o", str(tmp_path / "probe")], capture_output=True)
    return res.returncode == 0


def test_ubsan_build_reports_nothing(tmp_path):
    """The port's copy built with ``-fsanitize=undefined
    -fno-sanitize-recover`` runs the search, decode and truncation over
    streams with large negative residuals without a report, and writes the
    ``-O3`` build's bytes."""
    if not _ubsan_available(tmp_path):
        pytest.skip("the C++ toolchain has no libubsan")
    driver = tmp_path / "driver.cc"
    driver.write_text(UBSAN_DRIVER)
    outs = {}
    for name, flags in (("o3", ["-O3"]),
                        ("ubsan", ["-O1", "-fsanitize=undefined",
                                   "-fno-sanitize-recover"])):
        exe = tmp_path / name
        subprocess.run([os.environ.get("CXX", "g++"), "-std=c++17", *flags,
                        f"-I{NATIVE}", str(driver), "-o", str(exe)],
                       check=True, capture_output=True)
        res = subprocess.run([str(exe)], capture_output=True, timeout=120)
        assert res.returncode == 0 and res.stderr == b"", res.stderr[-2000:]
        outs[name] = res.stdout
    assert outs["ubsan"] == outs["o3"]
    assert len(outs["o3"]) > 97 * 32 * 2 * 2
