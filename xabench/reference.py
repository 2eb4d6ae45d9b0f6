"""The plain reference of the BandJAM XA codec, in plain PyTorch.

Written from the format's specification (``bjxa.5``): a block is one
profile byte (factor in the high nibble, < 5; range in the low nibble) and
32 samples packed in their top ``bits`` bits; each sample is
``(value >> range) + gain / 256`` with the two-tap gain of the factor,
divided truncating toward zero as C does, saturated to int16, and the
predictor state carries across blocks for the life of a channel.  The
encode is the greedy search every encoder of this project defines: per
block, all 80 profiles run the decoder's recurrence, the float32 squared
error accumulates in sample order, and the first strict minimum wins.

Nothing here imports the program under test.  Every function works on the
device of the tensors it is given (the card after a run's window has
closed, the CPU in the tests), over all blocks at once: a block's result
depends only on its entry state, so a stream is solved by iterating the
entry states to their fixed point, which is the sequential answer.
"""

from __future__ import annotations

import struct

import torch

BLOCK_SAMPLES = 32
NUM_FACTORS = 5
NUM_RANGES = 16
NUM_CANDIDATES = NUM_FACTORS * NUM_RANGES
GAIN_K0 = (0, 240, 460, 392, 488)
GAIN_K1 = (0, 0, -208, -220, -240)
INT16_MIN = -32768
INT16_MAX = 32767

XA_HEADER = struct.Struct("<4sIIHBBI4hI")
WAV_HEADER = struct.Struct("<4sI8sIHHIIHH4sI")

#: Candidate-blocks searched at once (bounds the search's memory, about
#: 300 bytes a candidate-block).
SEARCH_CHUNK = 1 << 22


def block_size(bits: int) -> int:
    return 4 * bits + 1


def div_trunc(g: torch.Tensor) -> torch.Tensor:
    """``g / 256`` truncated toward zero, as C divides."""
    return torch.where(g >= 0, g >> 8, -((-g) >> 8))


def div_floor(g: torch.Tensor) -> torch.Tensor:
    """``g >> 8``: floor division, the control's broken guarantee."""
    return g >> 8


# ---------------------------------------------------------------- headers


def xa_header(data_len: int, samples: int, rate: int, bits: int,
              channels: int) -> bytes:
    """The 32-byte XA header an encoder writes: zero loop, seeds, pad."""
    return XA_HEADER.pack(b"KWD1", data_len, samples, rate, bits, channels,
                          0, 0, 0, 0, 0, 0)


def parse_xa(image: bytes) -> dict:
    (magic, data_len, samples, rate, bits, channels, loop, *seeds,
     _pad) = XA_HEADER.unpack(image[:XA_HEADER.size])
    return dict(magic=magic, data_len=data_len, samples=samples, rate=rate,
                bits=bits, channels=channels, loop=loop, seeds=seeds)


def wav_header(data_len: int, rate: int, channels: int) -> bytes:
    """The canonical 44-byte RIFF/WAVE header of 16-bit PCM."""
    return WAV_HEADER.pack(b"RIFF", 36 + data_len, b"WAVEfmt ", 16, 1,
                           channels, rate, rate * 2 * channels, 2 * channels,
                           16, b"data", data_len)


def wav_image(pcm: torch.Tensor, rate: int) -> bytes:
    """A WAVE image of ``pcm`` int16 ``[frames, channels]``."""
    body = pcm.to(torch.int16).cpu().contiguous().numpy().astype("<i2")
    return wav_header(body.nbytes, rate, pcm.shape[1]) + body.tobytes()


# --------------------------------------------------------- bit (un)packing


def _sext16(v: torch.Tensor) -> torch.Tensor:
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def unpack(payload: torch.Tensor, bits: int) -> torch.Tensor:
    """``uint8[..., 4*bits]`` packed samples -> int32 ``[..., 32]``, each
    in the top ``bits`` bits of an int16, sign-extended."""
    b = payload.to(torch.int32)
    lead = b.shape[:-1]
    if bits == 4:
        out = torch.stack([(b & 0xF0) << 8, (b & 0x0F) << 12], -1)
    elif bits == 6:
        t = b.reshape(*lead, 8, 3)
        w = (t[..., 0] << 16) | (t[..., 1] << 8) | t[..., 2]
        out = torch.stack([(w >> 18) << 10, ((w >> 12) & 63) << 10,
                           ((w >> 6) & 63) << 10, (w & 63) << 10], -1)
    elif bits == 8:
        out = b << 8
    else:
        raise ValueError(f"bad bit depth {bits}")
    return _sext16(out.reshape(*lead, BLOCK_SAMPLES))


def pack(samples: torch.Tensor, bits: int) -> torch.Tensor:
    """The top ``bits`` bits of int16-domain ``[..., 32]`` samples ->
    ``uint8[..., 4*bits]``."""
    u = samples.to(torch.int32) & 0xFFFF
    lead = u.shape[:-1]
    if bits == 4:
        p = u.reshape(*lead, 16, 2)
        out = ((p[..., 0] >> 8) & 0xF0) | (p[..., 1] >> 12)
    elif bits == 6:
        q = (u >> 10).reshape(*lead, 8, 4)
        w = (q[..., 0] << 18) | (q[..., 1] << 12) | (q[..., 2] << 6) | q[..., 3]
        out = torch.stack([w >> 16, (w >> 8) & 0xFF, w & 0xFF], -1)
        out = out.reshape(*lead, 24)
    elif bits == 8:
        out = u >> 8
    else:
        raise ValueError(f"bad bit depth {bits}")
    return out.to(torch.uint8)


# ------------------------------------------------------------------ decode


def _gains(factor: torch.Tensor):
    k0 = torch.tensor(GAIN_K0, dtype=torch.int32, device=factor.device)
    k1 = torch.tensor(GAIN_K1, dtype=torch.int32, device=factor.device)
    f = factor.clamp(0, NUM_FACTORS - 1).long()
    return k0[f], k1[f]


def filter_blocks(vals: torch.Tensor, profiles: torch.Tensor,
                  state: torch.Tensor, div=div_trunc) -> torch.Tensor:
    """Decode blocks each from its own entry state.

    ``vals`` int32 ``[N, 32]`` unpacked samples, ``profiles`` int32 ``[N]``,
    ``state`` int32 ``[N, 2]`` (last sample, the one before).  Returns the
    int32 ``[N, 32]`` samples."""
    k0, k1 = _gains(profiles >> 4)
    ranged = vals >> (profiles & 15)[:, None]
    p0, p1 = state[:, 0].clone(), state[:, 1].clone()
    out = torch.empty_like(vals)
    for n in range(BLOCK_SAMPLES):
        s = (ranged[:, n] + div(p0 * k0 + p1 * k1)).clamp(INT16_MIN,
                                                          INT16_MAX)
        out[:, n] = s
        p0, p1 = s, p0
    return out


def solve_stream(step, nblocks: int, lanes: int, state0: torch.Tensor):
    """The sequential answer of a chain of blocks by its fixed point.

    ``step(idx, entry)`` maps block-lane indices ``idx`` (into the
    ``nblocks * lanes`` block-major items) and their entry states int32
    ``[n, 2]`` to a tuple of tensors, the first the int32 samples
    ``[n, 32]`` whose last two give the next block's entry state.  Entry
    states start at ``state0`` (int32 ``[lanes, 2]``) for block 0 and at
    zero elsewhere; each pass redoes the items whose entry state changed,
    until none does.  Block ``b`` of every lane is right after ``b + 1``
    passes, so this ends.  Returns ``(outputs, passes)``: the tuple of
    ``step``'s outputs over all items, in item order.
    """
    dev = state0.device
    n = nblocks * lanes
    entry = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    entry[:lanes] = state0
    idx = torch.arange(n, device=dev)
    outs = step(idx, entry)
    passes = 1
    while True:
        nxt = idx[idx + lanes < n]
        new = torch.stack([outs[0][nxt, 31], outs[0][nxt, 30]], -1)
        moved = (new != entry[nxt + lanes]).any(-1)
        idx = nxt[moved] + lanes
        if not idx.numel():
            return outs, passes
        entry[idx] = new[moved]
        for o, part in zip(outs, step(idx, entry[idx])):
            o[idx] = part
        passes += 1


def _stack_lanes(parts, Bmax: int, fill_shape, dtype, device):
    """Stack per-stream ``[B_i, C_i, ...]`` tensors into one block-major
    ``[Bmax, sum C_i, ...]`` tensor, zero past each stream's end.  Returns
    it and each stream's lane slice."""
    L = sum(p.shape[1] for p in parts)
    out = torch.zeros((Bmax, L, *fill_shape), dtype=dtype, device=device)
    slices, lane = [], 0
    for p in parts:
        sl = slice(lane, lane + p.shape[1])
        out[:p.shape[0], sl] = p
        slices.append(sl)
        lane = sl.stop
    return out, slices


def decode_streams(payloads, bits: int, states=None, div=div_trunc):
    """Decode XA payloads of one bit depth, each ``uint8 [B_i, C_i, S]`` on
    the device that does the work, all at once (streams never interact).
    ``states`` gives each stream's entry state int32 ``[C_i, 2]`` (zero by
    default).  Returns each stream's int16 frames ``[B_i * 32, C_i]``.
    Raises ``ValueError`` on a profile factor of 5 or more, as the format
    does."""
    dev = payloads[0].device
    Bmax = max(p.shape[0] for p in payloads)
    blocks, slices = _stack_lanes(payloads, Bmax, (block_size(bits),),
                                  torch.uint8, dev)
    L = blocks.shape[1]
    prof = blocks[:, :, 0].to(torch.int32).reshape(-1)
    if bool((prof >> 4 >= NUM_FACTORS).any()):
        raise ValueError("invalid block profile factor")
    vals = unpack(blocks[:, :, 1:], bits).reshape(-1, BLOCK_SAMPLES)
    state0 = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    for sl, st in zip(slices, states or []):
        state0[sl] = st
    (out,), _ = solve_stream(
        lambda i, st: (filter_blocks(vals[i], prof[i], st, div),), Bmax, L,
        state0)
    out = out.reshape(Bmax, L, BLOCK_SAMPLES).transpose(1, 2)
    return [out[:p.shape[0], :, sl].reshape(-1, sl.stop - sl.start)
            .to(torch.int16) for p, sl in zip(payloads, slices)]


def xa_to_wav_many(images, device, div=div_trunc) -> list[bytes]:
    """The WAVE images the format defines for XA images (header seeds
    honoured), decoded together by bit depth."""
    heads = [parse_xa(im) for im in images]
    out = [None] * len(images)
    for bits in sorted({h["bits"] for h in heads}):
        idx = [i for i, h in enumerate(heads) if h["bits"] == bits]
        pays, states = [], []
        for i in idx:
            h = heads[i]
            if h["magic"] != b"KWD1":
                raise ValueError("bad magic")
            C = h["channels"]
            raw = bytearray(images[i][32:32 + h["data_len"]])
            pays.append(torch.frombuffer(raw, dtype=torch.uint8).to(device)
                        .reshape(-1, C, block_size(bits)))
            states.append(torch.tensor(h["seeds"], dtype=torch.int32,
                                       device=device).reshape(2, 2)[:C])
        for i, pcm in zip(idx, decode_streams(pays, bits, states, div)):
            out[i] = wav_image(pcm[:heads[i]["samples"]], heads[i]["rate"])
    return out


# ------------------------------------------------------------------ search


def _candidates(bits: int, device):
    f = torch.arange(NUM_FACTORS, device=device).repeat_interleave(NUM_RANGES)
    r = torch.arange(NUM_RANGES, device=device).repeat(NUM_FACTORS)
    k0, k1 = _gains(f)
    shq = 16 - bits
    col = lambda t: t.to(torch.int32)[:, None]  # noqa: E731
    return dict(k0=col(k0), k1=col(k1), r=col(r),
                down=col((shq - r).clamp(min=0)),
                up=col((r - shq).clamp(min=0)),
                use_down=(r <= shq)[:, None],
                prof=((f << 4) | r).to(torch.int32))


def search_blocks(x: torch.Tensor, state: torch.Tensor, bits: int,
                  err_dtype=torch.float32):
    """The greedy choice of every block from its own entry state.

    ``x`` int32 ``[N, 32]`` target samples, ``state`` int32 ``[N, 2]``.
    Returns ``(profile int32 [N], coded int32 [N, 32], recon int32
    [N, 32])``: ``coded`` holds each sample's code in its top ``bits`` bits.
    ``err_dtype`` is float32 as specified; the control passes a lower one.
    """
    N = x.shape[0]
    if N > SEARCH_CHUNK // NUM_CANDIDATES:
        step = SEARCH_CHUNK // NUM_CANDIDATES
        parts = [search_blocks(x[i:i + step], state[i:i + step], bits,
                               err_dtype) for i in range(0, N, step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    c = _candidates(bits, x.device)
    shq = 16 - bits
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    bias = (1 << c["down"]) >> 1
    a0 = state[:, 0][None, :].expand(NUM_CANDIDATES, N)
    a1 = state[:, 1][None, :].expand(NUM_CANDIDATES, N)
    err = torch.zeros((NUM_CANDIDATES, N), dtype=err_dtype, device=x.device)
    codes, recs = [], []
    for n in range(BLOCK_SAMPLES):
        xn = x[:, n][None, :]
        pred = div_trunc(a0 * c["k0"] + a1 * c["k1"])
        diff = xn - pred
        q = torch.where(c["use_down"], (diff + bias) >> c["down"],
                        diff << c["up"]).clamp(qmin, qmax)
        d = q << shq
        rec = ((d >> c["r"]) + pred).clamp(INT16_MIN, INT16_MAX)
        e = (xn - rec).to(err_dtype)
        err = err + e * e
        codes.append(d)
        recs.append(rec)
        a0, a1 = rec, a0
    best = torch.argmin(err, dim=0)  # the first minimum
    pick = lambda rows: torch.stack(  # noqa: E731
        [r.gather(0, best[None, :])[0] for r in rows], -1)
    return c["prof"][best], pick(codes), pick(recs)


def block_bytes(profile: torch.Tensor, coded: torch.Tensor,
                bits: int) -> torch.Tensor:
    """``uint8 [..., 4*bits + 1]`` XA blocks from profiles and codes."""
    return torch.cat([profile.to(torch.uint8)[..., None], pack(coded, bits)],
                     -1)


def _pcm_blocks(pcms):
    """Int16 ``[frames_i, C_i]`` streams -> int32 ``[Bmax, L, 32]`` blocks
    (zero past each stream's end), each stream's lane slice, and ``B_i``."""
    parts = []
    for pcm in pcms:
        frames, C = pcm.shape
        B = -(-frames // BLOCK_SAMPLES)
        x = torch.zeros((B * BLOCK_SAMPLES, C), dtype=torch.int32,
                        device=pcm.device)
        x[:frames] = pcm.to(torch.int32)
        parts.append(x.reshape(B, BLOCK_SAMPLES, C).transpose(1, 2))
    Bmax = max(p.shape[0] for p in parts)
    x, slices = _stack_lanes(parts, Bmax, (BLOCK_SAMPLES,), torch.int32,
                             pcms[0].device)
    return x, slices, [p.shape[0] for p in parts]


def _split(blocks: torch.Tensor, slices, nblocks):
    return [blocks[:B, sl] for sl, B in zip(slices, nblocks)]


def encode_streams(pcms, bits: int, err_dtype=torch.float32):
    """The greedy search's XA payloads of int16 ``[frames_i, C_i]`` streams
    from the zero state, each ``uint8 [B_i, C_i, 4*bits + 1]``: the
    sequential search, solved by its fixed point."""
    x, slices, nblocks = _pcm_blocks(pcms)
    Bmax, L, _ = x.shape
    rows = x.reshape(-1, BLOCK_SAMPLES)

    def step(i, st):
        prof, coded, rec = search_blocks(rows[i], st, bits, err_dtype)
        return rec, prof, coded

    zero = torch.zeros((L, 2), dtype=torch.int32, device=x.device)
    (_, prof, coded), _ = solve_stream(step, Bmax, L, zero)
    return _split(block_bytes(prof, coded, bits).reshape(Bmax, L, -1),
                  slices, nblocks)


def _entry_from(samples: torch.Tensor) -> torch.Tensor:
    """Entry states ``[B, L, 2]`` of blocks whose predecessors' samples are
    ``samples`` int32 ``[B, L, 32]`` (zero for block 0)."""
    entry = torch.zeros((*samples.shape[:2], 2), dtype=torch.int32,
                        device=samples.device)
    entry[1:, :, 0] = samples[:-1, :, 31]
    entry[1:, :, 1] = samples[:-1, :, 30]
    return entry


def encode_open_loop(pcms, bits: int):
    """XA payloads of int16 streams in one pass: every block searched from
    the state the source itself gives at its start (its two samples
    before).  Valid streams whose decode tracks the source; the benchmark's
    way to make XA inputs without the sequential search."""
    x, slices, nblocks = _pcm_blocks(pcms)
    prof, coded, _ = search_blocks(x.reshape(-1, BLOCK_SAMPLES),
                                   _entry_from(x).reshape(-1, 2), bits)
    return _split(block_bytes(prof, coded, bits).reshape(*x.shape[:2], -1),
                  slices, nblocks)


def xa_image(payload: torch.Tensor, frames: int, rate: int,
             bits: int) -> bytes:
    """An XA image of ``payload`` ``uint8 [blocks, C, S]``."""
    raw = payload.cpu().contiguous().numpy().tobytes()
    return xa_header(len(raw), frames, rate, bits, payload.shape[1]) + raw


def judge_encoded(images, pcms, rates, bits: int) -> list[int]:
    """How many blocks of each XA image differ from the greedy search's
    choice for the int16 ``[frames, C]`` source ``pcm`` (on the device
    that does the work); every block counts as wrong where the header or a
    profile byte is not what the format asks.

    Each image is decoded here; each block's entry state is then the one
    its own predecessors give, and the block must be the search's choice
    from it.  Block 0 starts from the zero state the header must carry, so
    by induction an image whose every block equals its choice is the
    sequential search's: the check is exact, and it searches every block
    once, in parallel, instead of in sequence.
    """
    S = block_size(bits)
    wrong = [None] * len(images)
    keep = []
    for i, (image, pcm, rate) in enumerate(zip(images, pcms, rates)):
        frames, C = pcm.shape
        B = -(-frames // BLOCK_SAMPLES)
        want = dict(magic=b"KWD1", data_len=B * C * S, samples=frames,
                    rate=rate, bits=bits, channels=C, loop=0,
                    seeds=[0, 0, 0, 0])
        if len(image) != 32 + B * C * S or parse_xa(image) != want:
            wrong[i] = B * C
            continue
        blocks = torch.frombuffer(bytearray(image[32:]), dtype=torch.uint8)
        blocks = blocks.to(pcm.device).reshape(B, C, S)
        if bool((blocks[:, :, 0] >> 4 >= NUM_FACTORS).any()):
            wrong[i] = B * C
            continue
        keep.append((i, blocks))
    if not keep:
        return wrong
    idx, blocks = zip(*keep)
    decoded = decode_streams(list(blocks), bits)
    dec, slices, nblocks = _pcm_blocks(decoded)
    x, _, _ = _pcm_blocks([pcms[i] for i in idx])
    prof, coded, _ = search_blocks(x.reshape(-1, BLOCK_SAMPLES),
                                   _entry_from(dec).reshape(-1, 2), bits)
    best = _split(block_bytes(prof, coded, bits).reshape(*x.shape[:2], -1),
                  slices, nblocks)
    for i, got, want in zip(idx, blocks, best):
        wrong[i] = int((got != want).any(-1).sum())
    return wrong
