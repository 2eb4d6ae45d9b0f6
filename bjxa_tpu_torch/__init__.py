"""bjxa_tpu_torch: the BandJAM XA codec engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`bjxa_tpu` (the JAX/Pallas engine, kept as the reference).
This package holds the whole-file XA -> WAVE decode path, the
WAVE -> XA profile-search encode path, their segmented bounded-memory
twins, the batched corpus engine, the multi-device and multi-process layer
(:mod:`bjxa_tpu_torch.parallel`) and the measurement scripts
(:mod:`bjxa_tpu_torch.bench`, :mod:`bjxa_tpu_torch.benchmarks`,
:mod:`bjxa_tpu_torch.tools`): header parsing and validation with the same
typed errno-style errors, the chunk-parallel exact fixed-point decoder and
search encoder, batch decode and encode over files x channels lanes, the
block-at-a-time codec objects (:mod:`bjxa_tpu_torch.codec`) on the native
host library (:mod:`bjxa_tpu_torch.native`, with the drop-in C ABI), and a
``bjxa``-compatible ``decode``/``encode``/``corpus``/``abi`` CLI.  It
imports no JAX.
"""

__version__ = "0.5.0"

from bjxa_tpu_torch.errors import (
    BjxaError,
    BjxaFault,
    BjxaInvalidState,
    BjxaBufferError,
    BjxaProtocolError,
    BjxaIOError,
    BjxaBadFileError,
)
from bjxa_tpu_torch.format import (
    XA_HEADER_SIZE,
    RIFF_HEADER_SIZE,
    BLOCK_SAMPLES,
    XAFormat,
    RiffFormat,
    parse_xa_header,
    dump_xa_header,
    parse_riff_header,
    dump_riff_header,
    dump_pcm,
    load_pcm,
)
from bjxa_tpu_torch.api import (
    decode_xa,
    xa_to_wav,
    encode_pcm,
    wav_to_xa,
    decode_xa_stream,
    encode_wav_stream,
)
from bjxa_tpu_torch.parallel.corpus import decode_corpus, encode_corpus
from bjxa_tpu_torch.utils.hygiene import clear_compiled_caches

__all__ = [
    "__version__",
    "BjxaError",
    "BjxaFault",
    "BjxaInvalidState",
    "BjxaBufferError",
    "BjxaProtocolError",
    "BjxaIOError",
    "BjxaBadFileError",
    "XA_HEADER_SIZE",
    "RIFF_HEADER_SIZE",
    "BLOCK_SAMPLES",
    "XAFormat",
    "RiffFormat",
    "parse_xa_header",
    "dump_xa_header",
    "parse_riff_header",
    "dump_riff_header",
    "dump_pcm",
    "load_pcm",
    "decode_xa",
    "xa_to_wav",
    "encode_pcm",
    "wav_to_xa",
    "decode_xa_stream",
    "encode_wav_stream",
    "decode_corpus",
    "encode_corpus",
    "clear_compiled_caches",
]
