"""The ``bjxa`` command-line tool, PyTorch/CUDA edition.

Same surface as the reference CLI (``src/bjxa.c:36-52``): ``help``,
``decode [<xa> [<wav>]]`` and ``encode [--bits <4|6|8>] [--truncate]
[<wav> [<xa>]]``, with ``-`` or omitted filenames meaning stdin/stdout, and
:mod:`bjxa_tpu.cli`'s extensions: ``corpus`` for whole directories,
``decode --streaming`` (the incremental block-at-a-time codec of
:mod:`bjxa_tpu_torch.codec` on the host, the same bytes as the whole-file
path), ``abi --install <prefix>`` (the drop-in libbjxa-compatible C
library, :mod:`bjxa_tpu_torch.native.abi`), ``--devices`` and the
multi-process corpus flags.  Exit codes, output bytes and error labels are
those of :mod:`bjxa_tpu.cli` (the reference's perror style, ``<failing
stage>: <strerror>``), so scripted callers keep working.  As there,
``encode`` runs the filter-profile search by default and ``--truncate``
reproduces the reference's truncation-only encoder byte-for-byte.

The device is resolved once per action: ``BJXA_PLATFORM=cpu`` selects the
CPU, anything else the CUDA card.  Without a card the tool exits 1 and
says so; it never carries on on the CPU on its own.  ``decode
--streaming`` and ``abi`` run on the host alone and need no device.  A
process meshes its local devices (:func:`_local_devices`: every CUDA
device, or the CPU alone under ``BJXA_PLATFORM=cpu``) when there are
several; ``--devices``/``BJXA_DEVICES`` caps their count, and 1 keeps the
single-device path.  ``corpus --coordinator/--num-processes/--process-id``
(or ``BJXA_COORDINATOR``/``BJXA_NUM_PROCESSES``/``BJXA_PROCESS_ID``) join a
multi-process job (:mod:`bjxa_tpu_torch.parallel.distributed`): each
process converts its share of the files on its own devices, and process 0
prints the job's totals.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bjxa_tpu_torch.errors import BjxaError, BjxaProtocolError
from bjxa_tpu_torch.format import (
    BLOCK_SAMPLES,
    RIFF_HEADER_SIZE,
    XA_HEADER_SIZE,
    XAFormat,
    dump_pcm,
    dump_riff_header,
    dump_xa_header,
    load_pcm,
    parse_riff_header,
    parse_xa_header,
)

USAGE = """Usage: {prog} <action> [args...]

Available actions:

  help
    Show this message and exit.

  decode [--streaming] [--devices <n>] [--segment-blocks <n>]
         [<xa file> [<wav file>]]
    Read an XA file and convert it into a WAV file.
    Long streams shard their block range across all
    local devices (sequence parallel); --devices caps
    the device count (BJXA_DEVICES env equivalent;
    1 forces single-device).
    --segment-blocks streams the file through the device
    in n-block segments (bounded memory, automatic above
    256 MB; override with BJXA_SEGMENT_THRESHOLD).
    Decodes on the CUDA device; BJXA_PLATFORM=cpu
    decodes on the CPU instead.  --streaming decodes
    block by block on the host (the native library, or
    numpy when BJXA_NO_NATIVE is set), same bytes.

  encode [--bits <4|6|8>] [--truncate] [--devices <n>]
         [--segment-blocks <n>] [<wav file> [<xa file>]]
    Read a WAV file and convert it into an XA file.
    The default number of bits per sample, when left
    unspecified is 6. --truncate disables the filter
    profile search (reference-compatible output).
    Long streams shard the search's block range across
    all local devices (sequence parallel); --devices
    caps the device count (BJXA_DEVICES env equivalent;
    1 forces single-device).
    --segment-blocks streams the file through the device
    in n-block segments (bounded memory, automatic above
    256 MB of PCM).
    Encodes on the CUDA device; BJXA_PLATFORM=cpu
    encodes on the CPU instead.

  abi --install <prefix>
    Build the drop-in libbjxa-compatible C library
    (the reference's 19 versioned symbols backed by
    this engine) and install lib/libbjxa.so.0,
    include/bjxa.h and lib/pkgconfig/bjxa.pc under
    <prefix>, ready for `cc app.c $(pkg-config
    --cflags --libs bjxa)`.

  corpus [--batch-files <n>] [--depth <k>] [--manifest <path>]
         [--devices <n>] [--encode [--bits <4|6|8>] [--truncate]]
         [--trace <dir>] [--stats] <xa dir> <wav dir>
    Decode every *.xa file in a directory to WAV files,
    batched on the device, restartable via a JSONL
    manifest (reruns skip already-converted files).
    On a multi-device host the file/channel lanes of
    every batch shard across all local devices (data
    parallel); --devices caps the device count
    (BJXA_DEVICES env equivalent; 1 forces one device).
    --depth bounds in-flight device batches and the
    host write backlog (default 3).
    With --encode (plus optional --bits/--truncate) the
    direction reverses: every *.wav encodes to XA.
    Multi-host: --coordinator <host:port> --num-processes
    <n> --process-id <i> (or BJXA_COORDINATOR /
    BJXA_NUM_PROCESSES / BJXA_PROCESS_ID) shard the file
    list across cooperating processes; the summary line
    reports cross-host totals. --trace <dir> captures a
    torch.profiler trace with the program's bjxa.* stage
    ranges; --stats prints throughput rates.
    Runs on the CUDA device; BJXA_PLATFORM=cpu runs on
    the CPU instead.
"""


def _local_devices():
    """The devices this process may mesh: every CUDA device, or the CPU
    alone under ``BJXA_PLATFORM=cpu``."""
    import torch

    if os.environ.get("BJXA_PLATFORM") == "cpu":
        return [torch.device("cpu")]
    from bjxa_tpu_torch.parallel.mesh import local_devices

    return local_devices()


def _mesh_devices(devices_opt: int | None):
    """Resolve the local device list for CLI auto-meshing.

    ``devices_opt`` (the --devices flag) falls back to ``BJXA_DEVICES``;
    unset means all local devices.  Local devices only: in a multi-process
    job each process meshes the devices it owns, and processes meet at the
    file-list level.

    Returns the device list, or None when only one device would be used
    (the single-device paths).
    """
    n = devices_opt
    source = "--devices"
    if n is None:
        env = os.environ.get("BJXA_DEVICES")
        if env:
            source = "BJXA_DEVICES"
            try:
                n = int(env)
            except ValueError:
                raise ValueError(f"Invalid BJXA_DEVICES {env!r}")
    devs = _local_devices()
    if n is not None:
        if n < 1 or n > len(devs):
            raise ValueError(
                f"{source} {n} out of range (1..{len(devs)} available)"
            )
        devs = devs[:n]
    return devs if len(devs) > 1 else None


def _dp_mesh(devices_opt: int | None):
    """Data-parallel mesh over the local devices (corpus lane sharding),
    or None for single-device runs."""
    devs = _mesh_devices(devices_opt)
    if devs is None:
        return None
    from bjxa_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devs, dp=len(devs), sp=1)


def _sp_mesh(devices_opt: int | None):
    """Sequence-parallel mesh over the local devices (long-stream block
    sharding), or None for single-device runs."""
    devs = _mesh_devices(devices_opt)
    if devs is None:
        return None
    from bjxa_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devs, dp=len(devs), sp=1, axis_names=("sp", "_"))


def _explicit_sp_mesh(devices_opt: int | None):
    """``(explicit, mesh, error)``: an explicit device request (flag or
    ``BJXA_DEVICES``) is validated eagerly -- the user asked for devices;
    the default path resolves its mesh only where device work happens."""
    explicit = devices_opt is not None or bool(os.environ.get("BJXA_DEVICES"))
    if not explicit:
        return False, None, None
    try:
        return True, _sp_mesh(devices_opt), None
    except ValueError as e:
        return True, None, f"bjxa: {e}\n"


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


def _run_on_files(args: list[str], run) -> int:
    """Open the input and output named by ``args`` (``-`` or omitted:
    stdin/stdout), return ``run(fin, fout)`` and close what was opened."""
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
        return run(fin, fout)
    finally:
        if close_in:
            fin.close()
        if close_out:
            fout.close()


def _select_device(action: str):
    """The device of ``action``: the CPU when ``BJXA_PLATFORM=cpu``,
    otherwise the CUDA card.  Returns ``(device, None)``, or
    ``(None, message)`` when there is no card."""
    import torch

    if os.environ.get("BJXA_PLATFORM") == "cpu":
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        return None, (
            f"CUDA is not available; set BJXA_PLATFORM=cpu to {action} on"
            " the CPU"
        )
    return torch.device("cuda"), None


def _cmd_decode(args: list[str], prog: str) -> int:
    streaming = False
    devices = None
    segment_blocks = None
    while args and args[0].startswith("--"):
        if args[0] == "--streaming":
            streaming = True
            args = args[1:]
        elif args[0] == "--segment-blocks":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --segment-blocks")
            segment_blocks = int(args[1])
            args = args[2:]
        elif args[0] == "--devices":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(args[1])
            args = args[2:]
        else:
            break
    if len(args) > 2:
        return _fail(prog, "Too many arguments")
    device = None  # the streaming codec runs on the host
    if not streaming:
        device, why = _select_device("decode")
        if device is None:
            sys.stderr.write(f"bjxa: {why}\n")
            return 1
    return _run_on_files(
        args,
        lambda fin, fout: _decode_stream(fin, fout, device, segment_blocks,
                                         streaming, devices),
    )


def _decode_stream(fin, fout, device, segment_blocks=None,
                   streaming: bool = False, devices=None) -> int:
    explicit, sp_mesh, err = _explicit_sp_mesh(devices)
    if err:
        sys.stderr.write(err)
        return 1
    header = fin.read(XA_HEADER_SIZE)
    if header is None or len(header) < XA_HEADER_SIZE:
        sys.stderr.write("bjxa_fread_header: Input/output error\n")
        return 1
    try:
        fmt = parse_xa_header(header)
    except BjxaError as e:
        _perror("bjxa_fread_header", e)
        return 1

    if streaming:
        return _decode_streaming(fin, fout, fmt, header)

    from bjxa_tpu_torch.ops.decode import (
        SEGMENT_BLOCKS,
        decode_bytes,
        segment_threshold,
    )

    if (
        segment_blocks
        or fmt.data_len + fmt.data_len_pcm > segment_threshold()
    ):
        if not explicit:
            sp_mesh = _sp_mesh(None)
        return _decode_segmented(
            fin, fout, fmt, segment_blocks or SEGMENT_BLOCKS, device,
            sp_mesh,
        )

    fout.write(
        dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    )
    payload = fin.read(fmt.data_len)
    if payload is None or len(payload) < fmt.data_len:
        return _decode_truncated(fout, payload or b"", fmt, device)

    if not explicit:
        sp_mesh = _sp_mesh(None)
    try:
        # long streams shard their block range over the local devices (the
        # sequence-parallel ring, bit-exact); decode_bytes ignores the mesh
        # for short streams, and there is none on a one-device host
        pcm = decode_bytes(payload, fmt, device=device, mesh=sp_mesh)
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


def _decode_streaming(fin, fout, fmt, header: bytes) -> int:
    """The reference's block loop (``src/bjxa_decode.c:102-161``) on the
    incremental :class:`~bjxa_tpu_torch.codec.Decoder`: the RIFF header,
    then one ``decode`` per effective block read."""
    from bjxa_tpu_torch.codec import Decoder

    fout.write(
        dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    )
    dec = Decoder()
    dec.parse_header(header)
    left = fmt.blocks
    while left > 0:
        raw = fin.read(fmt.block_size_xa)
        if raw is None or len(raw) < fmt.block_size_xa:
            sys.stderr.write("fread: End of file\n")
            return 1
        try:
            pcm = dec.decode(raw)
        except BjxaError as e:
            _perror("bjxa_decode", e)
            return 1
        fout.write(dump_pcm(pcm))
        left -= 1
    return 0


def _decode_segmented(fin, fout, fmt, segment_blocks: int, device,
                      mesh=None) -> int:
    """Bounded-memory decode loop (``api.decode_xa_stream``): segments
    stream through the device and land on disk as they finish; error
    labels match the one-shot paths (the reference's block loop emits the
    valid prefix before failing, ``src/bjxa_decode.c:122-152``).  With a
    mesh each segment shards across the local devices."""
    from bjxa_tpu_torch.api import decode_xa_stream

    try:
        decode_xa_stream(
            fin, fout, fmt, device=device, segment_blocks=segment_blocks,
            mesh=mesh,
        )
    except EOFError:
        sys.stderr.write("fread: End of file\n")
        return 1
    except BjxaProtocolError as e:
        _perror("bjxa_decode", e)
        return 1
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


def _cmd_encode(args: list[str], prog: str) -> int:
    bits = 6
    search = True
    devices = None
    segment_blocks = None
    while args and args[0].startswith("--"):
        if args[0] == "--bits":
            args = args[1:]
            if not args:
                return _fail(prog, "Missing number of bits per sample")
            try:
                bits = int(args[0])
            except ValueError:
                bits = -1
            if bits not in (4, 6, 8):
                return _fail(prog, "Invalid number of bits per sample")
            args = args[1:]
        elif args[0] == "--truncate":
            search = False
            args = args[1:]
        elif args[0] == "--segment-blocks":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --segment-blocks")
            segment_blocks = int(args[1])
            args = args[2:]
        elif args[0] == "--devices":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(args[1])
            args = args[2:]
        else:
            break
    if len(args) > 2:
        return _fail(prog, "Too many arguments")
    device, why = _select_device("encode")
    if device is None:
        sys.stderr.write(f"bjxa: {why}\n")
        return 1
    return _run_on_files(
        args,
        lambda fin, fout: _encode_stream(fin, fout, bits, search, device,
                                         segment_blocks, devices),
    )


def _encode_stream(fin, fout, bits: int, search: bool, device,
                   segment_blocks=None, devices=None) -> int:
    explicit, sp_mesh, err = _explicit_sp_mesh(devices)
    if err:
        sys.stderr.write(err)
        return 1
    header = fin.read(RIFF_HEADER_SIZE)
    if header is None or len(header) < RIFF_HEADER_SIZE:
        sys.stderr.write("bjxa_fread_riff_header: Input/output error\n")
        return 1
    try:
        rf = parse_riff_header(header)
    except BjxaError as e:
        _perror("bjxa_fread_riff_header", e)
        return 1

    from bjxa_tpu_torch.ops.decode import SEGMENT_BLOCKS, segment_threshold

    if segment_blocks or rf.data_len_pcm > segment_threshold():
        if not explicit and search:
            sp_mesh = _sp_mesh(None)
        return _encode_segmented(
            fin, fout, rf, bits, search, segment_blocks or SEGMENT_BLOCKS,
            device, sp_mesh,
        )

    body = fin.read(rf.data_len_pcm)
    if body is None or len(body) < rf.data_len_pcm:
        return _encode_truncated(fout, body or b"", rf, bits, search, device)

    from bjxa_tpu_torch.api import encode_pcm

    if not explicit and search:
        sp_mesh = _sp_mesh(None)
    try:
        # long streams shard the search's block range over the local
        # devices (the sequence-parallel ring, bit-identical to the
        # sequential greedy search); encode_pcm ignores the mesh for short
        # streams, and there is none on a one-device host
        xa = encode_pcm(
            load_pcm(body, rf.channels), rf.samples_rate, bits,
            search=search, device=device, mesh=sp_mesh,
        )
    except BjxaError as e:
        _perror("bjxa_encode", e)
        return 1
    fout.write(xa)
    return 0


def _encode_segmented(fin, fout, rf, bits: int, search: bool,
                      segment_blocks: int, device, mesh=None) -> int:
    """Bounded-memory encode loop (``api.encode_wav_stream``): segments of
    PCM stream through the device with the search state carried exactly,
    bit-identical to the one-shot encoder (the streaming reference loop
    writes the header before reading blocks,
    ``src/bjxa_encode.c:108-160``).  With a mesh each segment's search
    shards across the local devices."""
    from bjxa_tpu_torch.api import encode_wav_stream

    try:
        encode_wav_stream(
            fin, fout, bits, search=search, rf=rf, device=device,
            segment_blocks=segment_blocks, mesh=mesh,
        )
    except EOFError:
        sys.stderr.write("fread: End of file\n")
        return 1
    return 0


def _encode_truncated(fout, body, rf, bits: int, search: bool, device) -> int:
    """Short PCM body: write the XA header of the promised stream and the
    encode of the whole blocks that did arrive, then fail like the
    reference's streaming loop (``src/bjxa_encode.c:108-160`` writes the
    header before reading blocks, so truncated input still produces a
    prefix).

    The whole blocks encode from the zero entry state, exactly what the
    streaming encoder of :mod:`bjxa_tpu.codec` emits for them; with no
    whole block, nothing follows the header.
    """
    import torch

    from bjxa_tpu_torch.ops.encode import encode_stream_blocks

    channels = rf.channels
    fmt = XAFormat(
        data_len=-(-rf.samples // BLOCK_SAMPLES) * (bits * 4 + 1) * channels,
        samples=rf.samples,
        samples_rate=rf.samples_rate,
        bits=bits,
        channels=channels,
        initial_state=((0, 0), (0, 0)),
    ).validate()
    fout.write(dump_xa_header(fmt))
    nblocks = len(body) // (2 * channels) // BLOCK_SAMPLES
    if nblocks:
        frames = load_pcm(body[: nblocks * BLOCK_SAMPLES * 2 * channels],
                          channels)
        lanes = torch.from_numpy(
            frames.reshape(nblocks, BLOCK_SAMPLES, channels)
        ).to(device)
        blocks = encode_stream_blocks(lanes, bits=bits, search=search)
        fout.write(blocks.cpu().numpy().tobytes())
    sys.stderr.write("fread: End of file\n")
    return 1


def _cmd_corpus(args: list[str], prog: str) -> int:
    batch_files = 64
    depth = 3
    manifest = None
    encode = False
    bits = 6
    search = True
    saw_encode_opts = False
    coordinator = None
    num_processes = None
    process_id = None
    trace_dir = None
    stats = False
    devices = None

    def _take_value(args):
        if len(args) < 2:
            return None, args[1:]
        return args[1], args[2:]

    while args and args[0].startswith("--"):
        if args[0] == "--batch-files":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --batch-files")
            batch_files = int(val)
        elif args[0] == "--depth":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --depth")
            depth = int(val)
        elif args[0] == "--manifest":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing manifest path")
            manifest = val
        elif args[0] == "--encode":
            encode = True
            args = args[1:]
        elif args[0] == "--bits":
            val, args = _take_value(args)
            if val is None or val not in ("4", "6", "8"):
                return _fail(prog, "Invalid number of bits per sample")
            bits = int(val)
            saw_encode_opts = True
        elif args[0] == "--truncate":
            search = False
            saw_encode_opts = True
            args = args[1:]
        elif args[0] == "--coordinator":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing coordinator address")
            coordinator = val
        elif args[0] == "--num-processes":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --num-processes")
            num_processes = int(val)
        elif args[0] == "--process-id":
            val, args = _take_value(args)
            if val is None or not val.isdigit():
                return _fail(prog, "Invalid --process-id")
            process_id = int(val)
        elif args[0] == "--trace":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing trace directory")
            trace_dir = val
        elif args[0] == "--stats":
            stats = True
            args = args[1:]
        elif args[0] == "--devices":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(val)
        else:
            return _fail(prog, f"Unknown option {args[0]}")
    if saw_encode_opts and not encode:
        return _fail(prog, "--bits/--truncate require --encode")
    if len(args) != 2:
        return _fail(prog, "corpus needs an input and an output directory")
    in_dir, out_dir = args
    if not os.path.isdir(in_dir):
        sys.stderr.write(f"corpus: {in_dir}: Not a directory\n")
        return 1
    device, why = _select_device("convert")
    if device is None:
        sys.stderr.write(f"bjxa: {why}\n")
        return 1

    from bjxa_tpu_torch.parallel import distributed

    try:
        distributed.initialize(coordinator, num_processes, process_id)
    except ValueError as e:
        return _fail(prog, str(e))
    try:
        return _run_corpus(prog, in_dir, out_dir, device, devices, encode,
                           bits, search, batch_files, manifest, depth,
                           trace_dir, stats)
    finally:
        distributed.shutdown()


def _run_corpus(prog, in_dir, out_dir, device, devices, encode, bits,
                search, batch_files, manifest, depth, trace_dir,
                stats) -> int:
    """The corpus job of one process, then the job's totals: every process
    enters the reduction (a collective), process 0 prints them.  A
    single-process run reduces to the identity."""
    from bjxa_tpu_torch.parallel import distributed
    from bjxa_tpu_torch.parallel.corpus import decode_corpus, encode_corpus
    from bjxa_tpu_torch.utils.profiler import Profiler

    try:
        # the batches' file/channel lanes shard over every local device
        # (data parallel, zero communication); a one-device host gets None
        # and the single-device path
        mesh = _dp_mesh(devices)
    except ValueError as e:
        return _fail(prog, str(e))
    try:
        with Profiler(trace_dir).trace():
            if encode:
                res = encode_corpus(
                    in_dir, out_dir, device=device, bits=bits,
                    search=search, batch_files=batch_files,
                    manifest_path=manifest, mesh=mesh, depth=depth,
                )
            else:
                res = decode_corpus(
                    in_dir, out_dir, device=device, batch_files=batch_files,
                    manifest_path=manifest, mesh=mesh, depth=depth,
                )
    except (BjxaError, OSError) as e:
        _perror("corpus", e)
        return 1
    for path, why in sorted(res.failed.items()):
        sys.stderr.write(f"corpus: {path}: {why}\n")

    converted, skipped, nfailed = distributed.allreduce_sum(
        [res.converted, res.skipped, len(res.failed)]
    )
    counters = distributed.allreduce_counters(res.counters)
    index, _count = distributed.process_info()
    if index == 0:
        sys.stdout.write(
            f"converted {converted} skipped {skipped}"
            f" failed {nfailed}"
            f" samples {counters.samples}\n"
        )
        if stats:
            rates = counters.rates()
            sys.stdout.write(
                "stats"
                f" files_per_s {rates['files_per_s']:.2f}"
                f" msamples_per_s {rates['msamples_per_s']:.2f}"
                f" mb_in_per_s {rates['mb_in_per_s']:.2f}"
                f" mb_out_per_s {rates['mb_out_per_s']:.2f}"
                f" elapsed_s {rates['elapsed_s']:.3f}\n"
            )
    return 1 if res.failed else 0


def _cmd_abi(args: list[str], prog: str) -> int:
    """Install the drop-in C ABI (library + header + pkg-config + CLI)."""
    if len(args) != 2 or args[0] != "--install":
        return _fail(prog, "abi requires --install <prefix>")
    from bjxa_tpu_torch.native import abi

    try:
        paths = abi.install(args[1])
    except RuntimeError as exc:
        sys.stderr.write(f"abi: {exc}\n")
        return 1
    except OSError as exc:
        _perror("abi", exc)
        return 1
    for role in ("lib", "header", "pkgconfig", "bin"):
        if role in paths:
            sys.stdout.write(f"{role} {paths[role]}\n")
    return 0


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
    if action == "encode":
        return _cmd_encode(rest, prog)
    if action == "corpus":
        return _cmd_corpus(rest, prog)
    if action == "abi":
        return _cmd_abi(rest, prog)
    return _fail(prog, "Unknown action")


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
