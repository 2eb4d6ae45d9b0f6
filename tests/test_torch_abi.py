"""The port's drop-in C ABI (``bjxa_tpu_torch/native/bjxa_abi.cc``), the
cases of ``tests/test_c_abi.py`` on seeded streams and the saturation
vector in place of the reference fixtures:

* decode through the C API equals the port's whole-file decode, in memory
  and through ``FILE*`` streams from libc, block by block and whole;
* the errno contract (EFAULT/EINVAL/ENOBUFS/EPROTO/EIO) of the reference's
  ``test/test_libbjxa_api.c`` misuse matrix;
* truncation and search encode equal the port's encoder;
* every symbol at its version node, ``install`` plus a C client built
  against the installed files, and the C CLI (``bjxa_cli.c``);
* byte parity with the JAX package's copy of the library.
"""

import ctypes
import errno
import hashlib
import os
import subprocess

import numpy as np
import pytest

from bjxa_tpu.native import abi as jabi
from bjxa_tpu_torch import dump_pcm, dump_riff_header
from bjxa_tpu_torch.api import encode_pcm, xa_to_wav
from bjxa_tpu_torch.format.hexdsl import hex_to_bytes
from bjxa_tpu_torch.native import abi
from test_golden_decode import SATURATION_WAV_SHA1, SATURATION_XA
from test_torch_codec import make_xa

XA_HEADER = 32
RIFF_HEADER = 44
STREAMS = [(bits, channels) for bits in (4, 6, 8) for channels in (1, 2)]


def stream(bits, channels, samples=32 * 61 - 9):
    return make_xa(np.random.default_rng(10 * bits + channels), bits,
                   channels, samples)


def to_wav(xa: bytes) -> bytes:
    return xa_to_wav(xa, device="cpu")


@pytest.fixture(scope="module")
def L():
    return abi.lib()


@pytest.fixture()
def dec(L):
    handle = ctypes.c_void_p(L.bjxa_decoder())
    yield handle
    if handle.value:
        L.bjxa_free_decoder(ctypes.byref(handle))


@pytest.fixture()
def enc(L):
    handle = ctypes.c_void_p(L.bjxa_encoder())
    yield handle
    if handle.value:
        L.bjxa_free_encoder(ctypes.byref(handle))


def last_errno() -> int:
    return ctypes.get_errno()


def parse_ok(L, dec, data: bytes) -> abi.CFormat:
    assert L.bjxa_parse_header(dec, data, len(data)) == XA_HEADER
    fmt = abi.CFormat()
    assert L.bjxa_decode_format(dec, ctypes.byref(fmt)) == 0
    return fmt


def abi_decode_all(L, dec, payload: bytes, fmt: abi.CFormat) -> bytes:
    """One whole-buffer bjxa_decode call, then LE-serialize via dump_pcm."""
    dst = ctypes.create_string_buffer(fmt.data_len_pcm)
    assert L.bjxa_decode(dec, dst, len(dst), payload, len(payload)) == (
        fmt.blocks)
    out = ctypes.create_string_buffer(fmt.data_len_pcm)
    assert L.bjxa_dump_pcm(out, ctypes.cast(dst, ctypes.c_void_p),
                           fmt.data_len_pcm) == 0
    return out.raw


def abi_wav(L, xa: bytes) -> bytes:
    d = ctypes.c_void_p(L.bjxa_decoder())
    try:
        fmt = parse_ok(L, d, xa)
        riff = ctypes.create_string_buffer(RIFF_HEADER)
        assert L.bjxa_dump_riff_header(d, riff, RIFF_HEADER) == RIFF_HEADER
        return riff.raw + abi_decode_all(L, d, xa[XA_HEADER:], fmt)
    finally:
        L.bjxa_free_decoder(ctypes.byref(d))


# ---------------------------------------------------------------------------
# decode


@pytest.mark.parametrize("bits,channels", STREAMS)
def test_decode_memory_equals_whole_file(L, bits, channels):
    xa = stream(bits, channels)
    assert abi_wav(L, xa) == to_wav(xa)


def test_saturation_vector(L):
    wav = abi_wav(L, hex_to_bytes(SATURATION_XA))
    assert hashlib.sha1(wav).hexdigest() == SATURATION_WAV_SHA1


def test_progress_countdown_and_exhaustion(L, dec):
    """Block-at-a-time decode: progress counts down inside the decoder and
    decoding past the end raises EPROTO (reference src/libbjxa.c:617)."""
    xa = stream(6, 1)
    fmt = parse_ok(L, dec, xa)
    payload = xa[XA_HEADER:]
    out = bytearray()
    dst = ctypes.create_string_buffer(fmt.block_size_pcm)
    pos, pcm_left = 0, fmt.data_len_pcm
    for _ in range(fmt.blocks):
        chunk = payload[pos:pos + fmt.block_size_xa]
        assert L.bjxa_decode(dec, dst, len(dst), chunk, len(chunk)) == 1
        take = min(fmt.block_size_pcm, pcm_left)  # truncated final block
        out += dst.raw[:take]
        pcm_left -= take
        pos += fmt.block_size_xa
    assert pcm_left == 0 and len(out) == fmt.data_len_pcm
    ctypes.set_errno(0)
    assert L.bjxa_decode(dec, dst, len(dst), payload, fmt.block_size_xa) == -1
    assert last_errno() == errno.EPROTO
    assert bytes(out) == to_wav(xa)[RIFF_HEADER:]


def test_truncated_tail_stream(L, dec):
    """A stream whose last block is partial emits only the promised frames."""
    rng = np.random.default_rng(7)
    pcm = rng.integers(-3000, 3000, size=(40, 1), dtype=np.int16)
    xa = encode_pcm(pcm, 9000, bits=6, search=False, device="cpu")
    fmt = parse_ok(L, dec, xa)
    assert fmt.blocks == 2 and fmt.data_len_pcm == 80
    payload = xa[XA_HEADER:]
    dst = ctypes.create_string_buffer(fmt.block_size_pcm)
    assert L.bjxa_decode(dec, dst, len(dst), payload, fmt.block_size_xa) == 1
    first = bytes(dst.raw)
    assert L.bjxa_decode(dec, dst, len(dst), payload[fmt.block_size_xa:],
                         fmt.block_size_xa) == 1
    assert to_wav(xa)[RIFF_HEADER:] == first + dst.raw[:16]


@pytest.fixture(scope="module")
def libc():
    c = ctypes.CDLL(None, use_errno=True)
    c.fopen.restype = ctypes.c_void_p
    c.fopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    c.fclose.argtypes = [ctypes.c_void_p]
    c.fread.restype = ctypes.c_size_t
    c.fread.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                        ctypes.c_void_p]
    return c


@pytest.mark.parametrize("bits,channels", [(4, 1), (8, 2)])
def test_decode_file_streaming(L, libc, dec, tmp_path, bits, channels):
    xa = stream(bits, channels)
    (tmp_path / "in.xa").write_bytes(xa)
    src = libc.fopen(str(tmp_path / "in.xa").encode(), b"rb")
    dst = libc.fopen(str(tmp_path / "out.wav").encode(), b"wb")
    assert src and dst
    assert L.bjxa_fread_header(dec, src) == XA_HEADER
    fmt = abi.CFormat()
    assert L.bjxa_decode_format(dec, ctypes.byref(fmt)) == 0
    assert L.bjxa_fwrite_riff_header(dec, dst) == RIFF_HEADER
    buf_xa = ctypes.create_string_buffer(fmt.block_size_xa)
    buf_pcm = ctypes.create_string_buffer(fmt.block_size_pcm)
    pcm_left = fmt.data_len_pcm
    for _ in range(fmt.blocks):
        assert libc.fread(buf_xa, 1, fmt.block_size_xa, src) == (
            fmt.block_size_xa)
        assert L.bjxa_decode(dec, buf_pcm, fmt.block_size_pcm, buf_xa,
                             fmt.block_size_xa) == 1
        take = min(fmt.block_size_pcm, pcm_left)
        assert L.bjxa_fwrite_pcm(ctypes.cast(buf_pcm, ctypes.c_void_p), take,
                                 dst) == 0
        pcm_left -= take
    libc.fclose(src)
    libc.fclose(dst)
    assert (tmp_path / "out.wav").read_bytes() == to_wav(xa)


def test_fread_header_short_file(L, libc, dec, tmp_path):
    p = tmp_path / "short.xa"
    p.write_bytes(b"KWD1\x00")
    f = libc.fopen(str(p).encode(), b"rb")
    ctypes.set_errno(0)
    assert L.bjxa_fread_header(dec, f) == -1
    assert last_errno() == errno.EIO
    libc.fclose(f)


def test_fwrite_to_readonly_stream_fails(L, libc, dec, tmp_path):
    parse_ok(L, dec, stream(4, 1))
    p = tmp_path / "ro.bin"
    p.write_bytes(b"")
    f = libc.fopen(str(p).encode(), b"rb")  # read-only: fwrite must fail
    assert L.bjxa_fwrite_riff_header(dec, f) == -1
    pcm = (ctypes.c_int16 * 4)(1, 2, 3, 4)
    assert L.bjxa_fwrite_pcm(ctypes.cast(pcm, ctypes.c_void_p), 8, f) == -1
    libc.fclose(f)


# ---------------------------------------------------------------------------
# errno contract / misuse matrix (reference test/test_libbjxa_api.c)


def test_lifecycle_errno_matrix(L, enc):
    ctypes.set_errno(0)
    assert L.bjxa_free_decoder(None) == -1
    assert last_errno() == errno.EFAULT
    null = ctypes.c_void_p(None)
    ctypes.set_errno(0)
    assert L.bjxa_free_decoder(ctypes.byref(null)) == -1
    assert last_errno() == errno.EFAULT
    # an encoder is not a decoder: magic mismatch is EINVAL
    ctypes.set_errno(0)
    assert L.bjxa_free_decoder(ctypes.byref(enc)) == -1
    assert last_errno() == errno.EINVAL
    # successful free nulls the handle; freeing again is EFAULT
    d = ctypes.c_void_p(L.bjxa_decoder())
    assert L.bjxa_free_decoder(ctypes.byref(d)) == 0
    assert d.value is None
    ctypes.set_errno(0)
    assert L.bjxa_free_decoder(ctypes.byref(d)) == -1
    assert last_errno() == errno.EFAULT


def test_parse_header_errno_matrix(L, dec, enc):
    xa = stream(4, 1)
    for handle, err in [(None, errno.EFAULT), (enc, errno.EINVAL)]:
        ctypes.set_errno(0)
        assert L.bjxa_parse_header(handle, xa, len(xa)) == -1
        assert last_errno() == err
    ctypes.set_errno(0)
    assert L.bjxa_parse_header(dec, None, 32) == -1
    assert last_errno() == errno.EFAULT
    ctypes.set_errno(0)
    assert L.bjxa_parse_header(dec, xa, 31) == -1
    assert last_errno() == errno.ENOBUFS
    ctypes.set_errno(0)
    assert L.bjxa_parse_header(dec, b"JUNK" + xa[4:], len(xa)) == -1
    assert last_errno() == errno.EPROTO
    # a failed reparse is transactional: prior state intact
    parse_ok(L, dec, xa)
    before = abi.CFormat()
    L.bjxa_decode_format(dec, ctypes.byref(before))
    assert L.bjxa_parse_header(dec, b"KWD1" + b"\x00" * 28, 32) == -1
    after = abi.CFormat()
    assert L.bjxa_decode_format(dec, ctypes.byref(after)) == 0
    assert bytes(after) == bytes(before)


def test_decode_errno_matrix(L, dec):
    xa = stream(4, 1)
    dst = ctypes.create_string_buffer(4096)
    # before any header: EINVAL
    ctypes.set_errno(0)
    assert L.bjxa_decode(dec, dst, len(dst), xa, len(xa)) == -1
    assert last_errno() == errno.EINVAL
    ctypes.set_errno(0)
    fmt = abi.CFormat()
    assert L.bjxa_decode_format(dec, ctypes.byref(fmt)) == -1
    assert last_errno() == errno.EINVAL
    ctypes.set_errno(0)
    assert L.bjxa_dump_riff_header(dec, dst, RIFF_HEADER) == -1
    assert last_errno() == errno.EINVAL

    fmt = parse_ok(L, dec, xa)
    payload = xa[XA_HEADER:]
    for d, dl, s, sl, err in [
        (None, 64, payload, len(payload), errno.EFAULT),
        (dst, 64, None, len(payload), errno.EFAULT),
        (dst, fmt.block_size_pcm - 1, payload, len(payload), errno.ENOBUFS),
        (dst, len(dst), payload, fmt.block_size_xa - 1, errno.ENOBUFS),
    ]:
        ctypes.set_errno(0)
        assert L.bjxa_decode(dec, d, dl, s, sl) == -1
        assert last_errno() == err
    # invalid profile factor (0xff) in the stream: EPROTO
    bad = b"\xff" + payload[1:]
    ctypes.set_errno(0)
    assert L.bjxa_decode(dec, dst, len(dst), bad, fmt.block_size_xa) == -1
    assert last_errno() == errno.EPROTO


def test_riff_and_pcm_errno_matrix(L, dec):
    parse_ok(L, dec, stream(4, 1))
    buf = ctypes.create_string_buffer(64)
    ctypes.set_errno(0)
    assert L.bjxa_dump_riff_header(dec, buf, RIFF_HEADER - 1) == -1
    assert last_errno() == errno.ENOBUFS
    pcm = (ctypes.c_int16 * 4)(1, 2, 3, 4)
    pcm_p = ctypes.cast(pcm, ctypes.c_void_p)
    ctypes.set_errno(0)
    assert L.bjxa_dump_pcm(None, pcm_p, 8) == -1
    assert last_errno() == errno.EFAULT
    for n in (0, 3):  # empty and odd lengths
        ctypes.set_errno(0)
        assert L.bjxa_dump_pcm(buf, pcm_p, n) == -1
        assert last_errno() == errno.ENOBUFS
    assert L.bjxa_dump_pcm(buf, pcm_p, 8) == 0
    assert buf.raw[:8] == np.array([1, 2, 3, 4], "<i2").tobytes()


def test_encode_errno_matrix(L, enc, dec):
    fmt = abi.CFormat()
    pcm = np.zeros((64, 1), np.int16)
    dst = ctypes.create_string_buffer(1024)
    # uninitialized encoder
    ctypes.set_errno(0)
    assert L.bjxa_encode(enc, dst, len(dst), pcm.tobytes(), pcm.nbytes) == -1
    assert last_errno() == errno.EINVAL
    ctypes.set_errno(0)
    assert L.bjxa_encode_format(enc, ctypes.byref(fmt)) == -1
    assert last_errno() == errno.EINVAL
    ctypes.set_errno(0)
    assert L.bjxa_dump_header(enc, dst, XA_HEADER) == -1
    assert last_errno() == errno.EINVAL
    # init validation: sample_bits, bits, channels, samples
    fmt = abi.CFormat(data_len_pcm=128, samples_rate=9000, sample_bits=8,
                      channels=1)
    ctypes.set_errno(0)
    assert L.bjxa_encode_init(enc, ctypes.byref(fmt), 6) == -1
    assert last_errno() == errno.EINVAL
    fmt.sample_bits = 16
    ctypes.set_errno(0)
    assert L.bjxa_encode_init(enc, ctypes.byref(fmt), 5) == -1
    assert last_errno() == errno.EINVAL
    fmt.channels = 3
    ctypes.set_errno(0)
    assert L.bjxa_encode_init(enc, ctypes.byref(fmt), 6) == -1
    assert last_errno() == errno.EPROTO
    fmt.channels = 1
    fmt.data_len_pcm = 0  # no samples
    ctypes.set_errno(0)
    assert L.bjxa_encode_init(enc, ctypes.byref(fmt), 6) == -1
    assert last_errno() == errno.EPROTO
    # a decoder is not an encoder
    fmt = abi.CFormat(data_len_pcm=128, samples_rate=9000, sample_bits=16,
                      channels=1)
    ctypes.set_errno(0)
    assert L.bjxa_encode_init(dec, ctypes.byref(fmt), 6) == -1
    assert last_errno() == errno.EINVAL


def test_parse_riff_errno_matrix(L):
    fmt = abi.CFormat()
    wav = dump_riff_header(256, 9000, 1)
    ctypes.set_errno(0)
    assert L.bjxa_parse_riff_header(None, wav, len(wav)) == -1
    assert last_errno() == errno.EFAULT
    ctypes.set_errno(0)
    assert L.bjxa_parse_riff_header(ctypes.byref(fmt), wav, 43) == -1
    assert last_errno() == errno.ENOBUFS
    ctypes.set_errno(0)
    assert L.bjxa_parse_riff_header(ctypes.byref(fmt), b"RIFX" + wav[4:],
                                    len(wav)) == -1
    assert last_errno() == errno.EPROTO
    assert L.bjxa_parse_riff_header(ctypes.byref(fmt), wav, len(wav)) == (
        RIFF_HEADER)
    assert (fmt.data_len_pcm, fmt.samples_rate, fmt.channels,
            fmt.sample_bits) == (256, 9000, 1, 16)


# ---------------------------------------------------------------------------
# encode parity


def abi_encode_wav(L, wav: bytes, bits: int, search: bool = False) -> bytes:
    e = ctypes.c_void_p(L.bjxa_encoder())
    try:
        fmt = abi.CFormat()
        assert L.bjxa_parse_riff_header(ctypes.byref(fmt), wav, len(wav)) == (
            RIFF_HEADER)
        assert L.bjxa_encode_init(e, ctypes.byref(fmt), bits) == 0
        if search:
            assert L.bjxa_tpu_encode_search(e, 1) == 0
        hdr = ctypes.create_string_buffer(XA_HEADER)
        assert L.bjxa_dump_header(e, hdr, XA_HEADER) == XA_HEADER
        payload = wav[RIFF_HEADER:]
        dst = ctypes.create_string_buffer(fmt.blocks * fmt.block_size_xa)
        assert L.bjxa_encode(e, dst, len(dst), payload, len(payload)) == (
            fmt.blocks)
        return hdr.raw + dst.raw
    finally:
        L.bjxa_free_encoder(ctypes.byref(e))


def seeded_wav(bits, channels, frames=517, seed=0):
    rng = np.random.default_rng(seed + bits * 10 + channels)
    t = np.arange(frames)[:, None]
    sig = 20000 * np.sin(t / (3.0 + np.arange(channels)))
    sig = np.clip(sig + rng.normal(0, 6000, sig.shape), -32768, 32767)
    pcm = sig.astype(np.int16)
    return pcm, dump_riff_header(pcm.nbytes, 22050, channels) + dump_pcm(pcm)


@pytest.mark.parametrize("bits,channels", STREAMS)
@pytest.mark.parametrize("search", [False, True], ids=["truncate", "search"])
def test_encode_parity(L, bits, channels, search):
    pcm, wav = seeded_wav(bits, channels)
    assert abi_encode_wav(L, wav, bits, search) == encode_pcm(
        pcm, 22050, bits=bits, search=search, device="cpu")


@pytest.mark.parametrize("bits,channels", STREAMS)
def test_bytes_equal_jax_library(L, bits, channels):
    """The port's copy (signed shifts through ``uint32_t``) and the JAX
    package's give the same bytes: decode of a seeded stream, and both
    encoders on a loud one."""
    JL = jabi.lib()
    xa = stream(bits, channels)
    assert abi_wav(L, xa) == abi_wav(JL, xa)
    _pcm, wav = seeded_wav(bits, channels, frames=32 * 40 + 3, seed=5)
    for search in (False, True):
        assert abi_encode_wav(L, wav, bits, search) == abi_encode_wav(
            JL, wav, bits, search)


def test_encode_matches_reference_binary(L, ref_bjxa):
    _pcm, wav = seeded_wav(6, 2, frames=333, seed=3)
    ref = subprocess.run([str(ref_bjxa), "encode", "--bits", "6"], input=wav,
                         capture_output=True, check=True).stdout
    assert abi_encode_wav(L, wav, 6) == ref


# ---------------------------------------------------------------------------
# install story: header + versioned .so + pkg-config + a real C client

CLIENT = r"""
#include <assert.h>
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <bjxa.h>

/* Decodes the XA file on stdin to a WAV on stdout through the installed
 * library, after a few checks of the API on a hand-made header. */
int main(void) {
    uint8_t hdr[32] = "KWD1";
    hdr[4] = 25;   /* data_len */
    hdr[8] = 32;   /* samples */
    hdr[12] = 0x28; hdr[13] = 0x23;  /* 9000 */
    hdr[14] = 6; hdr[15] = 1;
    bjxa_decoder_t *dec = bjxa_decoder();
    bjxa_format_t fmt;
    assert(bjxa_parse_header(dec, hdr, sizeof hdr) == 32);
    assert(bjxa_decode_format(dec, &fmt) == 0);
    assert(fmt.blocks == 1 && fmt.block_size_xa == 25);
    assert(fmt.data_len_pcm == 64 && fmt.samples_rate == 9000);
    uint8_t block[25] = {0};
    int16_t one[32];
    assert(bjxa_decode(dec, one, sizeof one, block, sizeof block) == 1);
    for (int i = 0; i < 32; i++) assert(one[i] == 0);
    assert(bjxa_decode(dec, one, sizeof one, block, sizeof block) == -1);
    assert(errno == EPROTO);
    assert(strcmp(bjxa_tpu_version(), "0.5.0") == 0);

    static uint8_t xa[1 << 20];
    size_t n = fread(xa, 1, sizeof xa, stdin);
    assert(bjxa_parse_header(dec, xa, n) == 32);
    assert(bjxa_decode_format(dec, &fmt) == 0);
    uint8_t riff[44];
    assert(bjxa_dump_riff_header(dec, riff, sizeof riff) == 44);
    int16_t *pcm = malloc(fmt.blocks * fmt.block_size_pcm);
    assert(bjxa_decode(dec, pcm, fmt.blocks * fmt.block_size_pcm, xa + 32,
                       n - 32) == (int)fmt.blocks);
    fwrite(riff, 1, sizeof riff, stdout);
    assert(bjxa_fwrite_pcm(pcm, fmt.data_len_pcm, stdout) == 0);
    free(pcm);
    assert(bjxa_free_decoder(&dec) == 0 && dec == NULL);
    return 0;
}
"""


def build_client(tmp_path, prefix):
    client = tmp_path / "client.c"
    client.write_text(CLIENT)
    exe = tmp_path / "client"
    subprocess.run(
        [os.environ.get("CC", "cc"), "-O2", f"-I{prefix}/include",
         str(client), f"-L{prefix}/lib", "-lbjxa", "-o", str(exe)],
        check=True, capture_output=True)
    return exe


def test_install_and_c_client(L, tmp_path):
    prefix = tmp_path / "prefix"
    paths = abi.install(prefix)
    assert paths["lib"].exists() and paths["header"].exists()
    assert "Name: bjxa" in paths["pkgconfig"].read_text()
    assert paths["link"].resolve() == paths["lib"].resolve()
    exe = build_client(tmp_path, prefix)
    env = dict(os.environ, LD_LIBRARY_PATH=str(prefix / "lib"))
    sat = hex_to_bytes(SATURATION_XA)
    res = subprocess.run([str(exe)], input=sat, env=env,
                         capture_output=True, check=True)
    assert hashlib.sha1(res.stdout).hexdigest() == SATURATION_WAV_SHA1
    xa = stream(6, 2)
    res = subprocess.run([str(exe)], input=xa, env=env, capture_output=True,
                         check=True)
    assert res.stdout == to_wav(xa)


def test_symbol_versions(L):
    """Every reference symbol resolves at its reference version node."""
    out = subprocess.run(
        ["nm", "-D", "--defined-only", str(abi.so_path())],
        capture_output=True, check=True, text=True).stdout
    for sym, node in [
        ("bjxa_decode", "LIBBJXA_0.1"),
        ("bjxa_parse_header", "LIBBJXA_0.1"),
        ("bjxa_fwrite_pcm", "LIBBJXA_0.1"),
        ("bjxa_encode", "LIBBJXA_0.5"),
        ("bjxa_parse_riff_header", "LIBBJXA_0.5"),
        ("bjxa_tpu_version", "LIBBJXA_TPU_0.5"),
    ]:
        assert f"{sym}@@{node}" in out
    # nothing internal leaks: every exported T symbol is bjxa_*
    for line in out.splitlines():
        if " T " in line:
            assert line.split(" T ")[1].startswith("bjxa_")
    dyn = subprocess.run(["objdump", "-p", str(abi.so_path())],
                         capture_output=True, check=True, text=True).stdout
    assert any(line.split() == ["SONAME", "libbjxa.so.0"]
               for line in dyn.splitlines())


# ---------------------------------------------------------------------------
# the C CLI binary (built on the ABI; reference CLI surface)


@pytest.fixture(scope="module")
def ncli():
    return abi.cli_path()


@pytest.mark.parametrize("bits,channels", STREAMS)
def test_ncli_decode(ncli, tmp_path, bits, channels):
    xa = stream(bits, channels)
    (tmp_path / "in.xa").write_bytes(xa)
    out = tmp_path / "out.wav"
    subprocess.run([str(ncli), "decode", str(tmp_path / "in.xa"), str(out)],
                   check=True, capture_output=True)
    assert out.read_bytes() == to_wav(xa)


def test_ncli_stdio_modes(ncli):
    xa = hex_to_bytes(SATURATION_XA)
    piped = subprocess.run([str(ncli), "decode"], input=xa,
                           capture_output=True, check=True).stdout
    dashed = subprocess.run([str(ncli), "decode", "-", "-"], input=xa,
                            capture_output=True, check=True).stdout
    assert hashlib.sha1(piped).hexdigest() == SATURATION_WAV_SHA1
    assert dashed == piped


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_ncli_encode_matches_port(ncli, bits):
    pcm, wav = seeded_wav(bits, 2, frames=777, seed=bits)
    for extra, search in (([], False), (["--search"], True)):
        ours = subprocess.run([str(ncli), "encode", "--bits", str(bits),
                               *extra], input=wav, capture_output=True,
                              check=True).stdout
        assert ours == encode_pcm(pcm, 22050, bits=bits, search=search,
                                  device="cpu")


def test_ncli_search_mode_beats_truncation(ncli):
    t = np.arange(32 * 64)
    pcm = (12000 * np.sin(t / 9.0)).astype(np.int16).reshape(-1, 1)
    wav = dump_riff_header(pcm.nbytes, 22050, 1) + dump_pcm(pcm)

    def snr(xa: bytes) -> float:
        out = np.frombuffer(to_wav(xa)[RIFF_HEADER:], "<i2").astype(float)
        src = pcm.reshape(-1).astype(float)
        return 10 * np.log10((src**2).sum() / ((src - out) ** 2).sum())

    def run(*extra):
        return subprocess.run([str(ncli), "encode", "--bits", "4", *extra],
                              input=wav, capture_output=True,
                              check=True).stdout

    assert snr(run("--search")) > snr(run()) + 5.0


def test_ncli_error_paths(ncli, tmp_path):
    def run(args, stdin=b""):
        return subprocess.run([str(ncli), *args], input=stdin,
                              capture_output=True)

    xa_path = tmp_path / "in.xa"
    xa_path.write_bytes(stream(4, 1))
    assert run([]).returncode == 1
    r = run(["frobnicate"])
    assert r.returncode == 1 and b"Unknown action" in r.stderr
    r = run(["decode", str(tmp_path / "nonexistent.xa")])
    assert r.returncode == 1 and b"No such file" in r.stderr
    r = run(["decode", str(xa_path), str(tmp_path / "no" / "dir.wav")])
    assert r.returncode == 1
    r = run(["decode"], stdin=b"KWD1 truncated")
    assert r.returncode == 1 and b"bjxa_fread_header" in r.stderr
    r = run(["decode"], stdin=b"JUNK" + b"\x00" * 40)
    assert r.returncode == 1 and b"bjxa_fread_header" in r.stderr
    r = run(["encode", "--bits", "5"])
    assert r.returncode == 1 and b"Invalid --bits" in r.stderr
    r = run(["encode", "--bits"])
    assert r.returncode == 1 and b"Missing --bits" in r.stderr
    r = run(["encode", "--frobnicate"])
    assert r.returncode == 1 and b"Unknown option" in r.stderr
    r = run(["decode", "a", "b", "c"])
    assert r.returncode == 1 and b"Too many" in r.stderr
    # corrupt mid-stream profile byte: decode fails with EPROTO label
    xa = bytearray(xa_path.read_bytes())
    xa[32 + 5 * 17] = 0xFF
    r = run(["decode"], stdin=bytes(xa))
    assert r.returncode == 1 and b"bjxa_decode: Protocol error" in r.stderr


def test_ncli_help(ncli):
    r = subprocess.run([str(ncli), "help"], capture_output=True)
    assert r.returncode == 0 and b"Usage:" in r.stdout


def test_install_includes_cli(L, tmp_path):
    paths = abi.install(tmp_path / "p")
    assert "bin" in paths
    r = subprocess.run([str(paths["bin"]), "help"], capture_output=True)
    # $ORIGIN/../lib rpath resolves the installed library
    assert r.returncode == 0 and b"Usage:" in r.stdout


def test_abi_benchmark_rehearsal(monkeypatch, capsys):
    """``benchmarks/abi.py`` on the CPU at a small size: one JSON line
    whose WAV is the port's decode of the same seeded stream."""
    import json

    from bjxa_tpu_torch.benchmarks import abi as bench

    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_REPS", "2")
    monkeypatch.setenv("BENCH_ABI_SECONDS", "1")
    monkeypatch.delenv("BJXA_REFERENCE_DIR", raising=False)
    record = bench.main()
    assert json.loads(capsys.readouterr().out) == record
    assert record["device"] == "cpu" and record["cpu"]
    assert record["samples"] == 44100 * 2 and record["abi_s_per_file"] > 0
    want = hashlib.sha1(to_wav(bench.synthetic_xa(1))).hexdigest()
    assert record["wav_sha1"] == want


def test_abi_benchmark_cpu_model_where_the_name_is_hidden(monkeypatch):
    """Where ``/proc/cpuinfo`` says ``model name: unknown`` the benchmark
    names the CPU by vendor, family and model numbers."""
    import io

    from bjxa_tpu_torch.benchmarks import abi as bench

    info = ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
            "model\t\t: 207\nmodel name\t: unknown\n\nprocessor\t: 1\n"
            "model name\t: other\n")
    monkeypatch.setattr(bench, "open", lambda *_a, **_k: io.StringIO(info),
                        raising=False)
    assert bench.cpu_model() == "GenuineIntel family 6 model 207"
    monkeypatch.setattr(bench, "open", lambda *_a, **_k: io.StringIO(
        info.replace("unknown", "Some CPU @ 2.0GHz")), raising=False)
    assert bench.cpu_model() == "Some CPU @ 2.0GHz"
