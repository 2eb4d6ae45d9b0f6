"""Why packed-int16 two-candidates-per-register encode evaluation cannot work.

Port of ``tools/encode_pack_falsify.py``.  The lead it closes: evaluate two
search candidates per 32-bit register by packing their lanes as 2 x int16,
for a potential ~2x on the throughput-bound 80-candidate sweep.  Two measurements:

1. **Semantic obstruction (numpy, any host)** -- the candidate recurrence's
   intermediates do not fit int16:

   * ``g = a0*k0 + a1*k1`` spans +-23.9M (25 bits): the products cannot even
     be FORMED in 16-bit lanes (a low-half multiply wraps);
   * ``pred = trunc(g/256)`` spans +-93k (18 bits) and ``diff = x - pred``
     +-125k (18 bits); C semantics clamp only at ``recon``, so these must
     survive unclamped between operations.

   :func:`semantic_report` measures, per signal regime, how often ``|pred|``
   and ``|diff|`` exceed int16 on random blocks, then simulates the two
   possible 16-bit repairs -- saturating each intermediate, or wrapping it --
   and counts blocks whose chosen profile diverges from the exact search.

2. **ALU rate (on the card, ``--bench``)** -- the per-element rate of the
   candidate operation mix in int16 against int32, through the probe kernel
   ``csrc/alu_mix.cu`` (which replaces the TPU kernel of
   ``bench_int16_vs_int32``).  The packing premise needs the 16-bit rate to
   be about twice the 32-bit one.  The int16 form runs two elements to a
   32-bit register, as the TPU kernel asked of its lanes: Hopper's 16x2
   adds, fused add-max and min do the pair in one instruction each, and the
   multiply and the shift, which have no 16x2 form, are composed: ``y*3``
   as ``y + y + y``, and ``>> 2`` on ``y`` held in offset binary (``y ^
   0x8000`` a half), where it is a logical shift: one mask (LOP3) keeps the
   high half's bits out of the low half, one LEA.HI shifts the word and
   adds the + 1, and the clip is the unsigned 16x2 max and min.
   The rates come from CUDA graphs of launches (the device alone); the tool
   prints the measured ratio with a verdict.  A rate that pays would not
   reopen a packed encoder: the semantic obstruction above stands.

Run: ``python -m bjxa_tpu_torch.tools.encode_pack_falsify``          (semantic)
     ``python -m bjxa_tpu_torch.tools.encode_pack_falsify --bench``  (card)
"""

from __future__ import annotations

import functools
import sys

import numpy as np

GK0 = np.array([0, 240, 460, 392, 488], np.int64)
GK1 = np.array([0, 0, -208, -220, -240], np.int64)
I16MIN, I16MAX = -32768, 32767


def _sat16(x):
    return np.clip(x, I16MIN, I16MAX)


def _wrap16(x):
    return ((np.asarray(x, np.int64) + 32768) & 0xFFFF) - 32768


def candidate_block(x, p0, p1, bits, factor, r, mode):
    """One candidate's exact/sat16/wrap16 block error + end state.

    ``mode``: 'exact' keeps full-width intermediates (the C semantics);
    'sat16' saturates g/pred/diff to int16 after each op (what saturating
    packed lanes would compute); 'wrap16' wraps them (what plain packed
    lanes would compute).
    """
    shq = 16 - bits
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    sd, su = max(shq - r, 0), max(r - shq, 0)
    bias = (1 << sd) >> 1
    k0, k1 = int(GK0[factor]), int(GK1[factor])
    fix = {"exact": lambda v: v, "sat16": _sat16, "wrap16": _wrap16}[mode]
    a0, a1 = np.asarray(p0, np.int64), np.asarray(p1, np.int64)
    err = np.zeros(np.shape(p0), np.float32)
    over_pred = 0
    over_diff = 0
    for n in range(32):
        g = fix(a0 * k0) + fix(a1 * k1) if mode != "exact" else (
            a0 * k0 + a1 * k1
        )
        g = fix(g)
        pred = (g + ((g >> 63) & 255)) >> 8
        over_pred += int(np.sum((pred > I16MAX) | (pred < I16MIN)))
        pred = fix(pred)
        diff = x[n] - pred
        over_diff += int(np.sum((diff > I16MAX) | (diff < I16MIN)))
        diff = fix(diff)
        q = (diff + bias) >> sd if r <= shq else diff << su
        q = np.clip(q, qmin, qmax)
        recon = np.clip(((q << shq) >> r) + pred, I16MIN, I16MAX)
        e = (x[n] - recon).astype(np.float32)
        err = err + e * e
        a1, a0 = a0, recon
    return err, over_pred, over_diff


def semantic_report(blocks=600, seed=0, bits=6):
    rng = np.random.default_rng(seed)
    regimes = {
        "quiet (|x|<2k)": 2_000,
        "audio (|x|<16k)": 16_000,
        "full-scale": 32_768,
    }
    print(f"bits={bits}, {blocks} random blocks per regime, 80 candidates")
    for name, amp in regimes.items():
        x = rng.integers(-amp, amp, size=(32, blocks))
        p0 = rng.integers(-amp, amp, size=blocks)
        p1 = rng.integers(-amp, amp, size=blocks)
        errs = {m: np.zeros((80, blocks), np.float32)
                for m in ("exact", "sat16", "wrap16")}
        opred = odiff = 0
        for factor in range(5):
            for r in range(16):
                c = factor * 16 + r
                for mode in errs:
                    e, op_, od_ = candidate_block(
                        x, p0, p1, bits, factor, r, mode
                    )
                    errs[mode][c] = e
                    if mode == "exact":
                        opred += op_
                        odiff += od_
        a_exact = np.argmin(errs["exact"], axis=0)
        div_sat = int(np.sum(np.argmin(errs["sat16"], axis=0) != a_exact))
        div_wrap = int(np.sum(np.argmin(errs["wrap16"], axis=0) != a_exact))
        tot = 32 * blocks * 80
        print(
            f"  {name:16s} |pred|>int16 {opred/tot:7.2%} of cand-samples,"
            f" |diff|>int16 {odiff/tot:7.2%};"
            f" profile divergence: sat16 {div_sat}/{blocks},"
            f" wrap16 {div_wrap}/{blocks}"
        )


#: Launches of the probe kernel in this process (plain runs never count).
LAUNCHES = 0
STEPS = 256
MIXES = {"full": 0, "clip": 1, "muladd": 2}
#: Integer instructions one int32 element-step of each mix needs, the fewest
#: that ``csrc/alu_mix.cu``'s SASS on sm_90a runs (``benchmarks/alu_pack.py``
#: counts them in the built library): muladd 1 IMAD (``x + 1`` does not
#: change inside the loop, so it is the multiply-add's addend); clip IMAD
#: and the max and min (2 VIMNMX); full IMAD, LEA.HI.SX32 (the shift and
#: the + 1), the max and min.
MIX_OPS = {"full": 4, "clip": 3, "muladd": 1}
#: Instructions one step of the packed int16 form needs for a PAIR of
#: elements, read from the same SASS: muladd 3 16x2 adds (VIADD.16x2 and
#: VIADDMNMX.S16x2, alternating); clip 2 VIADD.16x2, VIADDMNMX.S16x2,
#: VIMNMX.S16x2; full 3 VIADD.16x2, LOP3, LEA.HI (the shift and the + 1).
#: ``full``'s clip is not counted: on int16 it is the identity (``(s >> 2)
#: + 1`` lies in [-8191, 8192]).  The kernel still runs it (2 VIMNMX.U16x2,
#: 7 a pair), since the probe times the search's operation mix, in which
#: the clip does work.
PAIR_OPS = {"full": 5, "clip": 4, "muladd": 3}
SHAPE = (512, 1024)  # the same ELEMENT count for both element types
#: 16x2 constants of the packed form: the clip's bounds in each half.
CLIP_LO2, CLIP_HI2 = 0xC000C000, 0x3FFF3FFF


def step_ops(element_size: int, mix: str) -> float:
    """Integer instructions one element-step of ``mix`` needs, for the
    bound, counted the same way for both element types: ``MIX_OPS`` for
    int32 (``element_size`` 4), half of ``PAIR_OPS`` for the packed int16
    form (2)."""
    return MIX_OPS[mix] if element_size == 4 else PAIR_OPS[mix] / 2


def alu_mix_plain(x, *, mix: str):
    """Plain PyTorch version of the probe kernel, on any device: ``STEPS``
    dependent steps from ``y = x``, every operation wrapping in ``x``'s
    width (int32 or int16).  The arithmetic is int64 narrowed by hand after
    each operation: torch has no wrapping guarantee for signed overflow."""
    import torch

    if mix not in MIXES:
        raise ValueError(f"alu_mix: unknown mix {mix!r}")
    if x.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"alu_mix: want int32 or int16, got {x.dtype}")
    width = 32 if x.dtype == torch.int32 else 16
    half, mask = 1 << (width - 1), (1 << width) - 1

    def wrap(v):
        return ((v + half) & mask) - half

    xv = x.to(torch.int64)
    y = xv
    for _ in range(STEPS):
        y = wrap(wrap(y * 3) + xv)
        if mix == "full":
            y = y >> 2
        y = wrap(y + 1)
        if mix != "muladd":
            y = y.clamp(-16384, 16383)
    return y.to(x.dtype)


def _add2(a, b):
    """16x2 add of two 32-bit words held in int64, wrapping in each half
    (VIADD.16x2)."""
    return ((a + b) & 0xFFFF) | ((((a >> 16) + (b >> 16)) & 0xFFFF) << 16)


def _halves(w):
    """The signed low and high halves of 32-bit words (or of one int)."""
    return (((w & 0xFFFF) ^ 0x8000) - 0x8000,
            (((w >> 16) & 0xFFFF) ^ 0x8000) - 0x8000)


def _pick2(a, c: int, op, signed: bool):
    """Per-half ``op`` (``clamp_min`` for max, ``clamp_max`` for min) of
    words ``a`` and the constant word ``c``, signed (VIMNMX.S16x2) or
    unsigned (VIMNMX.U16x2)."""
    if signed:
        (lo, hi), (clo, chi) = _halves(a), _halves(c)
    else:
        lo, hi, clo, chi = a & 0xFFFF, a >> 16, c & 0xFFFF, c >> 16
    return ((getattr(lo, op)(clo) & 0xFFFF)
            | ((getattr(hi, op)(chi) & 0xFFFF) << 16))


def alu_mix_packed_plain(x, *, mix: str):
    """Plain PyTorch twin of the kernel's packed int16 form: ``x``'s
    elements two to a 32-bit word (held in int64; zero-padded to an even
    count), and each of the ``STEPS`` steps on the pair as the kernel runs
    it.  ``y*3 + x + 1`` is three 16x2 wrapping adds (``y+y``, ``y+(x+1)``,
    their sum); ``clip`` adds the signed 16x2 max and min.  ``full`` holds
    ``y`` in offset binary (``y ^ 0x8000`` in each half; ``y' + y'`` is
    ``2y``, so the adds give ``s ^ 0x8000``), clears the high half's two
    low bits, shifts the word right by 2, adds ``0x6001`` in each half
    (the ``+ 1``, with the bias the shift leaves moved back to ``0x8000``)
    and clips to ``[0x4000, 0xBFFF]`` with the unsigned 16x2 max and min.
    Equals :func:`alu_mix_plain` on int16."""
    import torch

    if mix not in MIXES:
        raise ValueError(f"alu_mix: unknown mix {mix!r}")
    if x.dtype != torch.int16:
        raise TypeError(f"alu_mix_packed_plain: want int16, got {x.dtype}")
    flat = x.reshape(-1).to(torch.int64) & 0xFFFF
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    xw = flat[0::2] | (flat[1::2] << 16)
    x1 = _add2(xw, 0x00010001)
    bias = 0x80008000 if mix == "full" else 0
    y = xw ^ bias
    for _ in range(STEPS):
        if mix == "full":
            s = _add2(_add2(y, y), _add2(y, xw))
            v = ((s & 0xFFFCFFFF) >> 2) + 0x60016001
            y = _pick2(_pick2(v, 0x40004000, "clamp_min", False),
                       0xBFFFBFFF, "clamp_max", False)
        else:
            y = _add2(_add2(y, y), _add2(y, x1))
            if mix == "clip":
                y = _pick2(_pick2(y, CLIP_LO2, "clamp_min", True), CLIP_HI2,
                           "clamp_max", True)
    lo, hi = _halves(y ^ bias)
    pairs = torch.stack([lo, hi], dim=1).reshape(-1)[:x.numel()]
    return pairs.to(torch.int16).reshape(x.shape)


@functools.cache
def persistent_ctas(element_size: int, mix: int, index: int) -> int:
    """CTAs of the probe kernel's persistent grid on card ``index``: its
    occupancy (CTAs an SM at once) times the SMs."""
    import torch

    from bjxa_tpu_torch.ops._build import check_launch, library

    fit = library().bjxa_alu_mix_occupancy(element_size, mix, index)
    check_launch(max(-fit, 0), "bjxa_alu_mix_occupancy")
    if fit == 0:
        raise RuntimeError("bjxa_alu_mix_occupancy: no CTA fits on an SM")
    return fit * torch.cuda.get_device_properties(index).multi_processor_count


def alu_mix(x, *, mix: str):
    """Run the candidate operation mix ``mix`` (``"full"``, ``"clip"`` or
    ``"muladd"``) elementwise over ``x`` (int32 or int16, any shape).

    Routes by the tensor's device alone: a CPU tensor takes
    :func:`alu_mix_plain`, a CUDA tensor launches the kernel, anything
    else raises.  Returns a tensor like ``x``; on the card it lies at the
    same address as ``x`` modulo 16 bytes (the kernel's vectors), for a
    view off a 16-byte boundary in a buffer up to 16 bytes longer.  ``x``
    may be any contiguous view, at any element offset, of fewer than 2**31
    elements.
    """
    global LAUNCHES
    import torch

    if x.device.type == "cpu":
        return alu_mix_plain(x, mix=mix)
    if x.device.type != "cuda":
        raise ValueError(f"alu_mix: no kernel for device {x.device}")
    from bjxa_tpu_torch.ops._build import check_launch, library

    if mix not in MIXES:
        raise ValueError(f"alu_mix: unknown mix {mix!r}")
    if x.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"alu_mix: want int32 or int16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("alu_mix: input must be contiguous")
    n, size = x.numel(), x.element_size()
    if n >= 2**31:
        raise ValueError(f"alu_mix: {n} elements; at most 2**31 - 1")
    if n == 0:
        return torch.empty_like(x)
    index = x.device.index
    ctas = persistent_ctas(size, MIXES[mix], index)
    out = torch.empty_like(x)
    if (out.data_ptr() - x.data_ptr()) % 16:  # x is a view off 16 bytes
        buf = torch.empty(n + 16 // size, dtype=x.dtype, device=x.device)
        lead = (x.data_ptr() - buf.data_ptr()) % 16 // size
        out = buf[lead:lead + n].view(x.shape)
    err = library().bjxa_alu_mix(
        x.data_ptr(), out.data_ptr(), n, size, MIXES[mix], ctas, index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "bjxa_alu_mix")
    LAUNCHES += 1
    return out


def probe_input(dtype, device, seed: int = 0):
    """Seeded int16-range elements of ``dtype`` at the probe's shape."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**15), 2**15, size=SHAPE).astype(np.int32)
    return torch.from_numpy(x).to(dtype).to(device)


def bench_int16_vs_int32(reps: int = 5) -> list[dict]:
    """Per-element ALU rate of the candidate op mix: int16 vs int32.  One
    JSON line per (element type, mix), then one per mix with the ratio and
    the verdict.  On the card the rate is taken from ``graph_ms``, 20
    launches captured in a CUDA graph (the device alone), with the eager
    window's ``ms`` beside it; the CPU rehearsal times with the host clock
    (``graph_ms`` null)."""
    import torch

    from bjxa_tpu_torch.benchmarks._common import bench_device, emit, time_ms

    device = bench_device()
    out, rates = [], {}
    n_ops = SHAPE[0] * SHAPE[1] * STEPS
    for dtype in (torch.int32, torch.int16):
        name = str(dtype).removeprefix("torch.")
        for mix in MIXES:
            x = probe_input(dtype, device)
            if not torch.equal(alu_mix(x, mix=mix),
                               alu_mix_plain(x, mix=mix)):
                raise AssertionError(f"alu_mix {name} {mix}: kernel and"
                                     " plain version differ")

            def call(x=x, mix=mix):
                return alu_mix(x, mix=mix)

            ms = time_ms(call, device, reps=reps)
            g_ms = None
            if device.type == "cuda":
                from bjxa_tpu_torch.benchmarks.short_stream import graph_ms

                g_ms = graph_ms(call, reps)
            rates[name, mix] = n_ops / (g_ms or ms) / 1e6
            out.append(emit({
                "metric": "alu_mix_rate", "dtype": name, "mix": mix,
                "value": round(rates[name, mix], 1),
                "unit": "Gelem-steps/s",
                "graph_ms": None if g_ms is None else round(g_ms, 6),
                "ms": round(ms, 6), "launches": LAUNCHES,
            }, device))
    for mix in MIXES:
        ratio = rates["int16", mix] / rates["int32", mix]
        out.append(emit({
            "metric": "int16_over_int32_rate", "mix": mix,
            "value": round(ratio, 3), "needs": 2.0,
            "pays": bool(ratio >= 1.5),
            "note": ("no packed 16-bit integer multiply or shift on this"
                     " card: the int16 form runs two elements to a 32-bit"
                     " register with 16x2 adds, add-max and min, y*3 as"
                     " y+y+y, and >> 2 on y in offset binary as one mask"
                     " (LOP3) and one LEA.HI that shifts and adds the + 1,"
                     " the clip an unsigned 16x2 max and min; the semantic"
                     " obstruction (18-25-bit intermediates) stands"
                     " whatever the ratio"),
        }, device))
    return out


if __name__ == "__main__":
    if "--bench" in sys.argv:
        bench_int16_vs_int32()
    else:
        semantic_report()
