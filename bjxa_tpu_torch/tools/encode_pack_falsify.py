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
   be about twice the 32-bit one.  Hopper has no packed 16-bit integer
   multiply or shift (its SIMD-in-a-word operations cover add, subtract,
   min, max and compares), so the 16-bit mix runs in 32-bit registers and
   lanes; the tool says so and prints the measured ratio with a verdict.

Run: ``python -m bjxa_tpu_torch.tools.encode_pack_falsify``          (semantic)
     ``python -m bjxa_tpu_torch.tools.encode_pack_falsify --bench``  (card)
"""

from __future__ import annotations

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
#: Integer instructions per step of each mix, a multiply-add counted as one:
#: multiply-add, (shift,) add, max, min.
MIX_OPS = {"full": 5, "clip": 4, "muladd": 2}
SHAPE = (512, 1024)  # the same ELEMENT count for both element types


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


def alu_mix(x, *, mix: str):
    """Run the candidate operation mix ``mix`` (``"full"``, ``"clip"`` or
    ``"muladd"``) elementwise over ``x`` (int32 or int16, any shape).

    Routes by the tensor's device alone: a CPU tensor takes
    :func:`alu_mix_plain`, a CUDA tensor launches the kernel, anything
    else raises.  Returns a tensor like ``x``.
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
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = library().bjxa_alu_mix(
        x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(),
        MIXES[mix], x.device.index,
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
    the verdict."""
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
            ms = time_ms(lambda: alu_mix(x, mix=mix), device, reps=reps)
            rates[name, mix] = n_ops / ms / 1e6
            out.append(emit({
                "metric": "alu_mix_rate", "dtype": name, "mix": mix,
                "value": round(rates[name, mix], 1),
                "unit": "Gelem-steps/s", "ms": round(ms, 6),
                "launches": LAUNCHES,
            }, device))
    for mix in MIXES:
        ratio = rates["int16", mix] / rates["int32", mix]
        out.append(emit({
            "metric": "int16_over_int32_rate", "mix": mix,
            "value": round(ratio, 3), "needs": 2.0,
            "pays": bool(ratio >= 1.5),
            "note": ("no packed 16-bit integer multiply or shift on this"
                     " card (SIMD-in-a-word covers add/sub/min/max only):"
                     " 16-bit elements run in 32-bit registers and lanes"),
        }, device))
    return out


if __name__ == "__main__":
    if "--bench" in sys.argv:
        bench_int16_vs_int32()
    else:
        semantic_report()
