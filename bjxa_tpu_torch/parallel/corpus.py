"""Corpus engine: batched, restartable XA<->WAV conversion on one device.

Port of the single-device path of :mod:`bjxa_tpu.parallel.corpus`, which
scales the reference's one-file-at-a-time CLI to directories of files:

* files are parsed host-side (headers only), grouped by (bits, channels)
  and a block-count bucket; each batch is one device program over
  ``files x channels`` lanes: one launch of the words decode kernel
  (:func:`~bjxa_tpu_torch.ops.decode.decode_batch_packed`), or one search
  over all the batch's blocks (:func:`~bjxa_tpu_torch.ops.encode.
  encode_batch_blocks`);
* batches run through a depth-k software pipeline: each batch is staged
  in pinned host memory and copied to the device without blocking, and
  its result is copied back into pinned memory behind a CUDA event, so
  host staging, transfers and device work of several batches overlap; a
  writer thread serializes and writes the files;
* a JSONL manifest makes runs restartable per file (SURVEY §5
  checkpoint/resume);
* each run times its own stages into ``counters.stage_ms``: host spans
  (``parse``, ``stage``, ``launch``, ``readback``, ``queue``, ``drain`` on
  the main thread, ``write`` on the writer thread) and, on a CUDA device,
  the batches' ``h2d``, ``compute`` and ``d2h`` between CUDA events.

Output bytes, failure messages, manifest names, counters and the
``.wav.tmp``/``.xa.tmp`` renames are those of :mod:`bjxa_tpu`.  A file above
:func:`~bjxa_tpu_torch.ops.decode.segment_threshold` never enters the
batcher: it streams through the segmented bounded-memory pipelines
(:func:`~bjxa_tpu_torch.api.decode_xa_stream`,
:func:`~bjxa_tpu_torch.api.encode_wav_stream`), one file at a time.

With a ``mesh`` (:mod:`bjxa_tpu_torch.parallel.mesh`) each batch's lanes
shard over its data-parallel axis instead
(:func:`~bjxa_tpu_torch.parallel.sharded.decode_corpus_sharded_words`,
:func:`~bjxa_tpu_torch.parallel.sharded.encode_corpus_sharded_flat`: the
same kernels, one launch a device), and an oversized file's segments
shard over the same devices as a sequence-parallel ring; that path times
host spans only.  In a multi-process job
(:mod:`bjxa_tpu_torch.parallel.distributed`) each process takes its
round-robin share of the sorted file list; ``process_index`` and
``process_count`` default to the live process group's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from bjxa_tpu_torch.api import decode_xa_stream, encode_wav_stream
from bjxa_tpu_torch.errors import BjxaError
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
from bjxa_tpu_torch.ops.decode import (
    decode_batch_packed,
    packed_layout,
    pad_bucket as _bucket,
    segment_threshold,
)
from bjxa_tpu_torch.ops.encode import encode_batch_blocks
from bjxa_tpu_torch.ops.readback import finish_readback, mark, start_readback
from bjxa_tpu_torch.utils.profiler import Counters
from bjxa_tpu_torch.utils.progress import Manifest


class _SerialWriter:
    """One background thread running queued jobs in submission order.

    The corpus engines hand each materialized batch's serialization +
    disk writes to this thread so the main thread can immediately block
    on the next batch's device->host transfer; ordering is preserved so
    manifest/counter updates stay sequential.

    The queue is bounded (``maxsize=depth``): if disk writes fall behind
    decode+readback, ``put`` blocks the producer, so host memory holds at
    most ~depth materialized batches (matching the device-side bound the
    pipeline depth provides).  A job exception re-raises at the next
    ``put`` — the producer stops staging/decoding further batches
    promptly instead of burning device time on work that will never be
    written — or in ``__exit__`` if no put follows.  On a producer-side
    exception (including KeyboardInterrupt), ``__exit__`` discards the
    pending backlog instead of draining it — the manifest makes the rerun
    pick up exactly the unwritten files.
    """

    def __init__(self, depth: int = 3):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max(depth, 1))
        self._exc = None
        self._abort = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._abort or self._exc is not None:
                continue
            fn, args = job
            try:
                fn(*args)
            except BaseException as e:  # surfaced at next put / __exit__
                self._exc = e

    def put(self, fn, *args):
        if self._exc is not None:
            raise self._exc
        self._q.put((fn, args))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._abort = True  # skip (don't run) the queued backlog
        self._q.put(None)
        self._thread.join()
        if exc_type is None and self._exc is not None:
            raise self._exc
        return False


def _run_pipelined(groups, batch_files, submit, flush, depth: int = 3):
    """Software pipeline over grouped batches, ``depth`` batches in flight.

    Invariant: submit(batch i+k) happens BEFORE flush(batch i) so host
    staging + async device work of upcoming batches overlap batch i's
    device compute and readback (CUDA work is queued asynchronously;
    flush waits for the batch's readback event).  ``depth`` bounds
    device-side queued batches so a slow consumer cannot accumulate
    unbounded device memory.
    """
    from collections import deque

    inflight: deque = deque()
    for key, items in sorted(groups.items()):
        # Every chunk of a group stages the same lane count (the group's
        # largest chunk); groups smaller than a full batch pad only to
        # their own size, not to batch_files.
        n_alloc = min(batch_files, len(items))
        for start in range(0, len(items), batch_files):
            chunk = items[start : start + batch_files]
            inflight.append(submit(*key, chunk, n_alloc))
            if len(inflight) >= max(depth, 1):
                flush(inflight.popleft())
    while inflight:
        flush(inflight.popleft())


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A zeroed host staging buffer, pinned when ``device`` is a CUDA
    device so its host->device copy runs without blocking.  The caller
    keeps it until the batch's readback has landed: a pinned buffer must
    not be reused while a copy from it is in flight."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _add_device_ms(counters: Counters, marks) -> None:
    """Add the device time between consecutive fired events ``marks``
    (before the upload, after it, after the compute, after the readback)
    to the ``h2d``, ``compute`` and ``d2h`` stages; nothing on the CPU."""
    if marks[0] is None:
        return
    for stage, a, b in zip(("h2d", "compute", "d2h"), marks, marks[1:]):
        counters.add_ms(stage, a.elapsed_time(b))


def _resolve_process(process_index, process_count):
    """Fill unspecified process coordinates from the live process group."""
    if process_index is None or process_count is None:
        from bjxa_tpu_torch.parallel.distributed import process_info

        auto_index, auto_count = process_info()
        if process_index is None:
            process_index = auto_index
        if process_count is None:
            process_count = auto_count
    return process_index, process_count


def _sp_remesh(mesh):
    """The devices of a (dp) ``mesh`` rebuilt as a sequence-parallel ring,
    or None when it has one device: an oversized file would otherwise
    leave every device but one idle."""
    if mesh is None:
        return None
    from bjxa_tpu_torch.parallel.mesh import make_mesh

    devs = list(mesh.devices.flat)
    if len(devs) < 2:
        return None
    return make_mesh(devs, dp=len(devs), sp=1, axis_names=("sp", "_"))


def _finish_shards(readbacks) -> np.ndarray:
    """Wait for every shard's readback (begun by :func:`start_readback`)
    and return their bytes as one host vector, shard-major."""
    return np.concatenate([finish_readback(*r) for r in readbacks])


@dataclasses.dataclass
class CorpusResult:
    converted: int
    skipped: int
    failed: dict[str, str]
    counters: Counters


def _list_inputs(inputs, pattern: str, process_index: int,
                 process_count: int) -> list[pathlib.Path]:
    if isinstance(inputs, (str, pathlib.Path)) and pathlib.Path(inputs).is_dir():
        paths = sorted(pathlib.Path(inputs).glob(pattern))
    else:
        paths = [pathlib.Path(p) for p in inputs]
    return paths[process_index::process_count]


def _read_payload(path, fmt: XAFormat) -> bytes:
    with open(path, "rb") as f:
        f.seek(XA_HEADER_SIZE)
        payload = f.read(fmt.data_len)
    if len(payload) < fmt.data_len:
        raise BjxaError("truncated payload")
    return payload


def stage_decode_batch(chunk, bits: int, channels: int, blocks: int,
                       lanes: int, failed: dict, device: torch.device):
    """Stage one decode batch into ONE packed int32 host buffer
    (:func:`~bjxa_tpu_torch.ops.decode.packed_layout`: payload words,
    profile bytes, predictor states), pinned for a CUDA ``device``.

    ``chunk`` is ``[(path, XAFormat)]``; file ``i`` owns lanes
    ``i*channels .. (i+1)*channels``.  A file that shrank or vanished since
    its header was parsed degrades per file: its message goes into
    ``failed``, its lanes stay zero (valid profile-0 dummies) and its index
    into the returned ``dead`` set.

    Returns ``(buf int32 tensor, valid bool[blocks, lanes] numpy, dead)``;
    validity comes from the staged profile bytes, on the host.
    """
    W = bits  # 4*bits payload bytes == bits int32 words
    size = 4 * bits + 1
    nw, npr, nst = packed_layout(blocks, lanes, bits)
    buf_t = _host_buffer(nw + npr + nst, torch.int32, device)
    buf = buf_t.numpy()
    words8 = buf[:nw].view(np.uint8).reshape(blocks, W, lanes, 4)
    prof = buf[nw : nw + npr].view(np.uint8)[: blocks * lanes].reshape(
        blocks, lanes
    )
    states = buf[nw + npr :].reshape(lanes, 2)
    dead = set()
    for i, (path, fmt) in enumerate(chunk):
        try:
            payload = _read_payload(path, fmt)
        except (BjxaError, OSError) as e:
            failed[str(path)] = str(e)
            dead.add(i)
            continue
        raw = np.frombuffer(
            payload, np.uint8, count=fmt.blocks * fmt.block_size_xa
        ).reshape(fmt.blocks, channels, size)
        ln = slice(i * channels, (i + 1) * channels)
        prof[: fmt.blocks, ln] = raw[:, :, 0]
        words8[: fmt.blocks, :, ln, :] = (
            raw[:, :, 1:].reshape(fmt.blocks, channels, W, 4)
            .transpose(0, 2, 1, 3)
        )
        states[ln] = fmt.initial_state_array()
    valid = (prof >> 4) < 5
    return buf_t, valid, dead


def decode_corpus(
    inputs,
    out_dir: str | pathlib.Path,
    *,
    device: torch.device | str,
    batch_files: int = 64,
    bucket_granularity: int = 256,
    manifest_path: str | pathlib.Path | None = None,
    mesh=None,
    process_index: int | None = None,
    process_count: int | None = None,
    depth: int = 3,
) -> CorpusResult:
    """Decode every XA file in ``inputs`` to WAV files in ``out_dir`` on
    ``device``, or on the devices of ``mesh``'s ``dp`` axis.

    ``inputs`` may be a directory (its ``*.xa``, sorted) or an iterable of
    paths; ``process_index``/``process_count`` pick this process's
    round-robin share of that list (default: the live process group's).
    ``depth`` bounds both the batches in flight on the device and the
    queued host-side write backlog.
    """
    process_index, process_count = _resolve_process(process_index,
                                                    process_count)
    device = torch.device(device)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = _list_inputs(inputs, "*.xa", process_index, process_count)
    manifest = Manifest(
        manifest_path
        if manifest_path is not None
        else out_dir / f".bjxa-manifest-{process_index}.jsonl"
    )

    counters = Counters()
    failed: dict[str, str] = {}
    skipped = 0
    converted = 0

    # ---- parse headers, group into (bits, channels, bucket) batches -----
    # Only headers are read here: payloads are (re)read at staging time,
    # so host memory is O(batch), not O(corpus).
    threshold = segment_threshold()
    groups: dict[tuple, list] = {}
    huge: list = []
    with counters.span("parse"):
        for path in paths:
            if manifest.is_done(str(path)):
                skipped += 1
                continue
            try:
                with open(path, "rb") as f:
                    fmt = parse_xa_header(f.read(XA_HEADER_SIZE))
                if path.stat().st_size < XA_HEADER_SIZE + fmt.data_len:
                    raise BjxaError("truncated payload")
            except (BjxaError, OSError) as e:
                failed[str(path)] = str(e)
                continue
            if fmt.data_len + fmt.data_len_pcm > threshold:
                huge.append((path, fmt))
                continue
            key = (fmt.bits, fmt.channels,
                   _bucket(fmt.blocks, bucket_granularity))
            groups.setdefault(key, []).append((path, fmt))

    # ---- oversized files: segmented bounded-memory decode ---------------
    sp_mesh = _sp_remesh(mesh) if huge else None
    for path, fmt in huge:
        out_path = out_dir / (path.stem + ".wav")
        tmp = out_path.with_suffix(".wav.tmp")
        try:
            with counters.span("segmented"):
                with open(path, "rb") as fin, open(tmp, "wb") as fout:
                    fin.seek(XA_HEADER_SIZE)
                    decode_xa_stream(fin, fout, fmt, device=device,
                                     mesh=sp_mesh)
                tmp.replace(out_path)
        except (BjxaError, EOFError, OSError) as e:
            failed[str(path)] = str(e)
            tmp.unlink(missing_ok=True)
            continue
        manifest.record(str(path), out=str(out_path), samples=fmt.samples)
        converted += 1
        counters.files += 1
        counters.blocks += fmt.blocks
        counters.samples += fmt.samples * fmt.channels
        counters.bytes_in += fmt.data_len
        counters.bytes_out += fmt.data_len_pcm + 44

    # ---- decode each group in device batches ----------------------------
    def submit(bits, channels, bucket, chunk, n_alloc):
        L = n_alloc * channels
        # The geometric bucket is only the grouping key; each chunk stages
        # and decodes at the linear granularity of its own largest file.
        bmax = max(f.blocks for _, f in chunk)
        Bs = min(bucket, -(-bmax // bucket_granularity) * bucket_granularity)
        with counters.span("stage"):
            buf, valid, dead = stage_decode_batch(
                chunk, bits, channels, Bs, L, failed, device
            )
        if mesh is not None:
            # the same staged words, profiles and states, each device's
            # lanes to that device: one words-kernel launch a device, flat
            # PCM back from each
            from bjxa_tpu_torch.parallel.sharded import (
                decode_corpus_sharded_words,
            )

            nw, npr, _nst = packed_layout(Bs, L, bits)
            host = buf.numpy()
            prof = host[nw : nw + npr].view(np.uint8)[: Bs * L]
            with counters.span("launch"):
                shards, reassemble = decode_corpus_sharded_words(
                    prof.reshape(Bs, L), host[:nw].reshape(Bs, bits, L),
                    host[nw + npr :].reshape(L, 2), bits=bits, mesh=mesh,
                )
                readback = ([start_readback(t) for t in shards], reassemble)
            return channels, Bs, chunk, dead, buf, readback, [None], valid
        # one host->device copy, one kernel launch, one readback
        with counters.span("launch"):
            marks = [mark(device)]
            dbuf = buf.to(device, non_blocking=True)
            marks.append(mark(device))
            pcm = decode_batch_packed(dbuf, bits=bits, blocks=Bs, lanes=L)
            marks.append(mark(device))
            readback = start_readback(pcm)
        return channels, Bs, chunk, dead, buf, readback, marks, valid

    def write_batch(channels, nblocks, chunk, dead, pcm, valid):
        nonlocal converted
        for i, (path, fmt) in enumerate(chunk):
            if i in dead:
                continue
            lanes = slice(i * channels, (i + 1) * channels)
            if not valid[: fmt.blocks, lanes].all():
                failed[str(path)] = "invalid block profile factor"
                continue
            out_path = out_dir / (path.stem + ".wav")
            tmp = out_path.with_suffix(".wav.tmp")
            try:
                with counters.span("write"):  # on the writer thread
                    frames = pcm[:, :, lanes].reshape(
                        nblocks * BLOCK_SAMPLES, channels
                    )[: fmt.samples]
                    wav = dump_riff_header(
                        fmt.data_len_pcm, fmt.samples_rate, fmt.channels
                    ) + dump_pcm(frames)
                    tmp.write_bytes(wav)
                    tmp.replace(out_path)
            except OSError as e:
                # degrade per file, like parse errors — the run continues
                failed[str(path)] = str(e)
                continue
            manifest.record(
                str(path), out=str(out_path), samples=fmt.samples
            )
            converted += 1
            counters.files += 1
            counters.blocks += fmt.blocks
            counters.samples += fmt.samples * fmt.channels
            counters.bytes_in += fmt.data_len
            counters.bytes_out += len(wav)

    def flush(pending):
        channels, nblocks, chunk, dead, _buf, readback, marks, valid = pending
        lanes_total = len(chunk) * channels
        if mesh is not None:  # the shards of a mesh
            readbacks, reassemble = readback
            with counters.span("readback"):
                pcm = reassemble(_finish_shards(readbacks))
        else:
            with counters.span("readback"):
                pcm = finish_readback(*readback)  # flat int16
            _add_device_ms(counters, marks + [readback[1]])
            pcm = pcm.reshape(nblocks, BLOCK_SAMPLES, -1)
        pcm = pcm[:, :, :lanes_total]
        # WAV serialization + disk writes run on the writer thread so the
        # next batch's transfer is not stalled behind file I/O.
        with counters.span("queue"):
            writer.put(write_batch, channels, nblocks, chunk, dead, pcm,
                       valid)

    with _SerialWriter(depth=depth) as writer:
        _run_pipelined(groups, batch_files, submit, flush, depth=depth)
        drain_from = time.perf_counter()  # then wait for the writer's backlog
    counters.add_ms("drain", (time.perf_counter() - drain_from) * 1e3)

    return CorpusResult(
        converted=converted,
        skipped=skipped,
        failed=failed,
        counters=counters.freeze(),
    )


def encode_corpus(
    inputs,
    out_dir: str | pathlib.Path,
    *,
    device: torch.device | str,
    bits: int = 6,
    search: bool = True,
    batch_files: int = 64,
    bucket_granularity: int = 256,
    manifest_path: str | pathlib.Path | None = None,
    mesh=None,
    process_index: int | None = None,
    process_count: int | None = None,
    depth: int = 3,
) -> CorpusResult:
    """Encode every WAV file in ``inputs`` to XA files in ``out_dir`` on
    ``device``, or on the devices of ``mesh``'s ``dp`` axis.

    The encoder analog of :func:`decode_corpus`: files group by
    (channels, block-count bucket), each batch runs the 80-profile search
    (or reference-compatible truncation) once over ``files x channels``
    lanes and all of the batch's blocks, and batches pipeline against host
    staging and writing.  Output bytes are identical to per-file
    :func:`bjxa_tpu_torch.api.encode_pcm`: lanes never interact.
    """
    process_index, process_count = _resolve_process(process_index,
                                                    process_count)
    device = torch.device(device)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = _list_inputs(inputs, "*.wav", process_index, process_count)
    if manifest_path is None:
        manifest_path = (
            out_dir / f".bjxa-encode-manifest-{process_index}.jsonl"
        )
    manifest = Manifest(manifest_path)

    counters = Counters()
    failed: dict[str, str] = {}
    skipped = 0
    converted = 0

    # Only headers are read here (payloads re-read at staging time:
    # O(batch) host memory).
    threshold = segment_threshold()
    groups: dict[tuple, list] = {}
    huge: list = []
    with counters.span("parse"):
        for path in paths:
            if manifest.is_done(str(path)):
                skipped += 1
                continue
            try:
                with open(path, "rb") as f:
                    rf = parse_riff_header(f.read(RIFF_HEADER_SIZE))
                if path.stat().st_size < RIFF_HEADER_SIZE + rf.data_len_pcm:
                    raise BjxaError("truncated PCM payload")
            except (BjxaError, OSError) as e:
                failed[str(path)] = str(e)
                continue
            if rf.data_len_pcm > threshold:
                huge.append((path, rf))
                continue
            nblocks = -(-rf.samples // BLOCK_SAMPLES)
            key = (rf.channels, _bucket(nblocks, bucket_granularity))
            groups.setdefault(key, []).append((path, rf))

    # ---- oversized WAVs: segmented bounded-memory encode ----------------
    # (The search carries sequential state: segments bound the memory, not
    # the time.)
    for path, rf in huge:
        out_path = out_dir / (path.stem + ".xa")
        tmp = out_path.with_suffix(".xa.tmp")
        try:
            with counters.span("segmented"):
                with open(path, "rb") as fin, open(tmp, "wb") as fout:
                    fin.seek(RIFF_HEADER_SIZE)
                    fmt = encode_wav_stream(fin, fout, bits, search=search,
                                            rf=rf, device=device)
                tmp.replace(out_path)
        except (BjxaError, EOFError, OSError) as e:
            failed[str(path)] = str(e)
            tmp.unlink(missing_ok=True)
            continue
        manifest.record(str(path), out=str(out_path), samples=rf.samples)
        converted += 1
        counters.files += 1
        counters.blocks += fmt.blocks
        counters.samples += rf.samples * rf.channels
        counters.bytes_in += rf.data_len_pcm
        counters.bytes_out += fmt.data_len + XA_HEADER_SIZE

    def _read_pcm(path, rf):
        with open(path, "rb") as f:
            f.seek(RIFF_HEADER_SIZE)
            body = f.read(rf.data_len_pcm)
        if len(body) < rf.data_len_pcm:
            raise BjxaError("truncated PCM payload")
        return load_pcm(body, rf.channels)

    def submit(channels, bucket, chunk, n_alloc):
        # Fixed lane count per group (see decode_corpus.submit); each chunk
        # stages at the linear granularity of its own largest file.
        L = n_alloc * channels
        dead = set()
        bmax = max(
            -(-rf.samples // BLOCK_SAMPLES) for _, rf in chunk
        )
        Bs = min(bucket, -(-bmax // bucket_granularity) * bucket_granularity)
        with counters.span("stage"):
            lanes = _host_buffer((Bs, BLOCK_SAMPLES, L), torch.int16, device)
            frames = lanes.numpy().reshape(Bs * BLOCK_SAMPLES, L)
            for i, (path, rf) in enumerate(chunk):
                try:
                    pcm = _read_pcm(path, rf)
                except (BjxaError, OSError) as e:
                    failed[str(path)] = str(e)
                    dead.add(i)
                    continue
                ln = slice(i * channels, (i + 1) * channels)
                frames[: pcm.shape[0], ln] = pcm
        if mesh is not None:
            from bjxa_tpu_torch.parallel.sharded import (
                encode_corpus_sharded_flat,
            )

            with counters.span("launch"):
                shards, reassemble = encode_corpus_sharded_flat(
                    lanes.numpy(), np.zeros((L, 2), np.int32), bits=bits,
                    search=search, mesh=mesh,
                )
                readback = ([start_readback(t) for t in shards], reassemble)
            return channels, L, chunk, dead, lanes, readback, [None]
        # one upload, one search (or truncation) over the whole batch, one
        # readback of the flat blocks
        with counters.span("launch"):
            marks = [mark(device)]
            dlanes = lanes.to(device, non_blocking=True)
            marks.append(mark(device))
            blocks = encode_batch_blocks(dlanes, bits=bits, search=search)
            marks.append(mark(device))
            readback = start_readback(blocks)
        return channels, L, chunk, dead, lanes, readback, marks

    def write_batch(channels, chunk, dead, blocks):
        nonlocal converted
        for i, (path, rf) in enumerate(chunk):
            if i in dead:
                continue
            ln = slice(i * channels, (i + 1) * channels)
            nblocks = -(-rf.samples // BLOCK_SAMPLES)
            out_path = out_dir / (path.stem + ".xa")
            tmp = out_path.with_suffix(".xa.tmp")
            try:
                with counters.span("write"):  # on the writer thread
                    payload = np.ascontiguousarray(
                        blocks[:nblocks, ln]
                    ).tobytes()
                    fmt = XAFormat(
                        data_len=len(payload),
                        samples=rf.samples,
                        samples_rate=rf.samples_rate,
                        bits=bits,
                        channels=channels,
                        initial_state=((0, 0), (0, 0)),
                    )
                    xa = dump_xa_header(fmt) + payload
                    tmp.write_bytes(xa)
                    tmp.replace(out_path)
            except OSError as e:
                failed[str(path)] = str(e)
                continue
            manifest.record(
                str(path), out=str(out_path), samples=rf.samples
            )
            converted += 1
            counters.files += 1
            counters.blocks += nblocks
            counters.samples += rf.samples * channels
            counters.bytes_in += rf.data_len_pcm
            counters.bytes_out += len(xa)

    def flush(pending):
        channels, L, chunk, dead, _lanes, readback, marks = pending
        if mesh is not None:  # the shards of a mesh
            readbacks, reassemble = readback
            with counters.span("readback"):
                blocks = reassemble(_finish_shards(readbacks))
        else:
            with counters.span("readback"):
                blocks = finish_readback(*readback)
            _add_device_ms(counters, marks + [readback[1]])
            blocks = blocks.reshape(-1, L, bits * 4 + 1)
        with counters.span("queue"):
            writer.put(write_batch, channels, chunk, dead, blocks)

    with _SerialWriter(depth=depth) as writer:
        _run_pipelined(groups, batch_files, submit, flush, depth=depth)
        drain_from = time.perf_counter()  # then wait for the writer's backlog
    counters.add_ms("drain", (time.perf_counter() - drain_from) * 1e3)

    return CorpusResult(
        converted=converted,
        skipped=skipped,
        failed=failed,
        counters=counters.freeze(),
    )
