"""The ``bjxa`` command-line tool, PyTorch/CUDA edition.

Same surface as the reference CLI (``src/bjxa.c:36-52``) for the actions
ported so far: ``help`` and ``decode [<xa> [<wav>]]``, with ``-`` or
omitted filenames meaning stdin/stdout.  Exit codes, output bytes and
error labels are those of :mod:`bjxa_tpu.cli` (the reference's perror
style, ``<failing stage>: <strerror>``), so scripted callers keep working.

The device is resolved once per decode: ``BJXA_PLATFORM=cpu`` selects the
CPU, anything else the CUDA card.  Without a card the tool exits 1 and
says so; it never carries on on the CPU on its own.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bjxa_tpu_torch.errors import BjxaError, BjxaProtocolError
from bjxa_tpu_torch.format import (
    XA_HEADER_SIZE,
    dump_pcm,
    dump_riff_header,
    parse_xa_header,
)

USAGE = """Usage: {prog} <action> [args...]

Available actions:

  help
    Show this message and exit.

  decode [<xa file> [<wav file>]]
    Read an XA file and convert it into a WAV file.
    Decodes on the CUDA device; BJXA_PLATFORM=cpu
    decodes on the CPU instead.
"""

#: Decode options of :mod:`bjxa_tpu.cli` that this tool does not have yet.
NOT_PORTED = ("--streaming", "--devices", "--segment-blocks")


def _usage(prog: str, file) -> None:
    file.write(USAGE.format(prog=prog))


def _fail(prog: str, msg: str) -> int:
    sys.stderr.write(f"bjxa: {msg}\n")
    _usage(prog, sys.stderr)
    return 1


def _perror(label: str, exc: BjxaError | OSError) -> None:
    err = getattr(exc, "errno", None) or 0
    text = os.strerror(err) if err else str(exc)
    sys.stderr.write(f"{label}: {text}\n")


def _open_input(path: str | None):
    if path is None or path == "-":
        return sys.stdin.buffer, False
    return open(path, "rb"), True


def _open_output(path: str | None):
    if path is None or path == "-":
        return sys.stdout.buffer, False
    return open(path, "wb"), True


def _select_device():
    """The decode device: the CPU when ``BJXA_PLATFORM=cpu``, otherwise
    the CUDA card.  Returns ``(device, None)``, or ``(None, message)``
    when there is no card."""
    import torch

    if os.environ.get("BJXA_PLATFORM") == "cpu":
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        return None, (
            "CUDA is not available; set BJXA_PLATFORM=cpu to decode on"
            " the CPU"
        )
    return torch.device("cuda"), None


def _cmd_decode(args: list[str], prog: str) -> int:
    if args and args[0] in NOT_PORTED:
        return _fail(prog, f"{args[0]} is not yet ported")
    if len(args) > 2:
        return _fail(prog, "Too many arguments")
    device, why = _select_device()
    if device is None:
        sys.stderr.write(f"bjxa: {why}\n")
        return 1

    try:
        fin, close_in = _open_input(args[0] if len(args) > 0 else None)
    except OSError as e:
        _perror("Error", e)
        return 1
    try:
        fout, close_out = _open_output(args[1] if len(args) > 1 else None)
    except OSError as e:
        _perror("Error", e)
        return 1

    try:
        return _decode_stream(fin, fout, device)
    finally:
        if close_in:
            fin.close()
        if close_out:
            fout.close()


def _decode_stream(fin, fout, device) -> int:
    header = fin.read(XA_HEADER_SIZE)
    if header is None or len(header) < XA_HEADER_SIZE:
        sys.stderr.write("bjxa_fread_header: Input/output error\n")
        return 1
    try:
        fmt = parse_xa_header(header)
    except BjxaError as e:
        _perror("bjxa_fread_header", e)
        return 1

    fout.write(
        dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    )
    payload = fin.read(fmt.data_len)
    if payload is None or len(payload) < fmt.data_len:
        return _decode_truncated(fout, payload or b"", fmt, device)

    from bjxa_tpu_torch.ops.decode import decode_bytes

    try:
        pcm = decode_bytes(payload, fmt, device=device)
    except BjxaProtocolError as e:
        # emit the valid prefix, as the reference's block loop does, then
        # report the failure (src/bjxa_decode.c:122-137)
        prefix = _decode_valid_prefix(payload, fmt, device)
        if prefix.size:
            fout.write(dump_pcm(prefix))
        _perror("bjxa_decode", e)
        return 1
    fout.write(dump_pcm(pcm))
    return 0


def _decode_truncated(fout, payload, fmt, device):
    """Short payload: emit the complete effective blocks that did arrive.

    Byte-parity with the reference's streaming loop
    (``src/bjxa_decode.c:122-152``): each complete block present decodes
    and writes before the short ``fread`` fails — and an invalid profile
    inside that prefix fails with the protocol error first.

    Work is capped at the blocks actually present, so a corrupt header
    promising a huge (up to u32) ``data_len`` costs O(available).
    """
    import dataclasses

    from bjxa_tpu_torch.ops.decode import decode_bytes_validity

    avail = len(payload) // fmt.block_size_xa
    if avail:
        # XAFormat.validate rejects a stereo data_len that is not a whole
        # number of effective blocks, so avail < fmt.blocks here.
        sub = dataclasses.replace(
            fmt,
            data_len=avail * fmt.block_size_xa,
            samples=min(fmt.samples, avail * 32),
        )
        frames, valid = decode_bytes_validity(
            payload[: sub.data_len], sub, device=device
        )
        v = valid.cpu().numpy().all(axis=1)
        first_bad = int(np.argmin(v)) if not v.all() else len(v)
        good = min(first_bad, avail)
        out = frames[: min(good * 32, sub.samples)].cpu().numpy()
        if out.size:
            fout.write(dump_pcm(out))
        if first_bad < avail:
            _perror("bjxa_decode", BjxaProtocolError("invalid profile"))
            return 1
    sys.stderr.write("fread: End of file\n")
    return 1


def _decode_valid_prefix(payload, fmt, device):
    """Frames of the effective blocks preceding the first invalid profile,
    through the same pipeline as the happy path."""
    from bjxa_tpu_torch.ops.decode import decode_bytes_validity

    frames, valid = decode_bytes_validity(payload, fmt, device=device)
    v = valid.cpu().numpy().all(axis=1)
    good = int(np.argmin(v)) if not v.all() else len(v)
    frames = frames[: good * 32].cpu().numpy()
    limit = fmt.data_len_pcm // (2 * fmt.channels)
    return frames[: min(len(frames), limit)]


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "bjxa"
    args = argv[1:]

    if not args:
        return _fail(prog, "Missing an action")
    action, rest = args[0], args[1:]
    if action == "help":
        _usage(prog, sys.stdout)
        return 0
    if action == "decode":
        return _cmd_decode(rest, prog)
    return _fail(prog, "Unknown action")


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
