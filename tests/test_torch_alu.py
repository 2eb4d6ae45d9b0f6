"""The ALU probe's packed int16 form (kernel 11, ``csrc/alu_mix.cu``) on the
CPU: its plain twin ``alu_mix_packed_plain`` -- two elements to a 32-bit
word, each step on the pair with the kernel's 16x2 adds, add-max and min,
and its shift composed in offset binary from a mask and a 32-bit shift --
against the plain version, at zero tolerance; the bound's instruction
counts; and the ablation script ``benchmarks/alu_pack.py``: its sources, its
SASS count and its CPU rehearsal.  The JAX probe kernel is a closure of
``tools/encode_pack_falsify.py`` and cannot be imported;
``tests/test_torch_bench.py`` holds ``alu_mix_plain`` to its contract.
"""

import json

import numpy as np
import pytest
import torch

from bjxa_tpu_torch.benchmarks import alu_pack
from bjxa_tpu_torch.benchmarks._common import NoDeviceError
from bjxa_tpu_torch.ops import _build
from bjxa_tpu_torch.tools import encode_pack_falsify as probe

I16 = np.iinfo(np.int16)


def _case(case: str) -> torch.Tensor:
    rng = np.random.default_rng(len(case))
    if case == "every value":
        return torch.arange(I16.min, I16.max + 1).to(torch.int16)
    if case == "one":
        return torch.tensor([I16.max], dtype=torch.int16)
    x = rng.integers(I16.min, I16.max + 1, size=(6, 50)).astype(np.int16)
    # the wrap cases of test_alu_mix_plain_matches_contract: the extremes,
    # and values whose y*3 + x overflows
    x[0, :6] = [I16.max, I16.min, I16.max // 3 + 1, -1, 0, 16383]
    x = torch.from_numpy(x)
    if case == "odd":
        return x.reshape(-1)[:247]
    if case == "view":  # offset 1 element: odd count, pairs shifted by one
        return x.reshape(-1)[1:]
    return x  # "wrap"


@pytest.mark.parametrize("case", ["every value", "one", "odd", "view",
                                  "wrap"])
@pytest.mark.parametrize("mix", list(probe.MIXES))
def test_packed_plain_matches_plain(mix, case):
    x = _case(case)
    before = probe.LAUNCHES
    got = probe.alu_mix_packed_plain(x, mix=mix)
    assert probe.LAUNCHES == before
    want = probe.alu_mix_plain(x, mix=mix)
    assert got.dtype == torch.int16 and got.shape == x.shape
    assert torch.equal(got, want)
    if case == "every value" and mix == "muladd":  # the halves do wrap
        assert int(want.abs().max()) > 16384


def test_packed_plain_refuses_other_types_and_mixes():
    x = torch.zeros(4, dtype=torch.int16)
    with pytest.raises(ValueError):
        probe.alu_mix_packed_plain(x, mix="fma")
    with pytest.raises(TypeError):
        probe.alu_mix_packed_plain(x.int(), mix="full")


def test_packed_halves_do_not_leak():
    """Each half is its own element: the high half's result does not depend
    on the low half's value, nor the low on the high."""
    hi = torch.full((64,), -12345, dtype=torch.int16)
    lo = torch.arange(-32, 32, dtype=torch.int16) * 1021
    pairs = torch.stack([lo, hi], dim=1).reshape(-1)
    for mix in probe.MIXES:
        got = probe.alu_mix_packed_plain(pairs, mix=mix).reshape(-1, 2)
        assert torch.equal(got[:, 0], probe.alu_mix_plain(lo, mix=mix))
        assert len(set(got[:, 1].tolist())) == 1


@pytest.mark.parametrize("mix", list(probe.MIXES))
def test_step_ops_count_each_element_type(mix):
    """Both element types count the fewest instructions their step runs in
    the SASS: int32 an element, the packed int16 form a pair, halved."""
    assert probe.step_ops(4, mix) == probe.MIX_OPS[mix]
    assert probe.step_ops(2, mix) == probe.PAIR_OPS[mix] / 2
    assert [probe.MIX_OPS[m] for m in probe.MIXES] == [4, 3, 1]
    assert [probe.PAIR_OPS[m] for m in probe.MIXES] == [5, 4, 3]


def test_full_clip_is_the_identity_on_int16():
    """The int16 bound leaves ``full``'s clip out: after a wrapping 16-bit
    ``y*3 + x``, ``(s >> 2) + 1`` always lies inside [-16384, 16383], so the
    plain version with the clip equals the same steps without it."""
    s = torch.arange(I16.min, I16.max + 1, dtype=torch.int64)
    v = (s >> 2) + 1
    assert int(v.min()) == -8191 and int(v.max()) == 8192
    x = torch.arange(I16.min, I16.max + 1).to(torch.int16)
    y = x.to(torch.int64)

    def wrap(t):
        return ((t + 32768) & 0xFFFF) - 32768

    for _ in range(probe.STEPS):
        y = wrap(wrap(wrap(y * 3) + x.to(torch.int64)) >> 2) + 1
    assert torch.equal(probe.alu_mix_plain(x, mix="full"), y.to(torch.int16))


# -- benchmarks/alu_pack.py ---------------------------------------------------


@pytest.mark.parametrize("form", alu_pack.forms(),
                         ids=lambda f: "{}{}x{}".format(*f))
def test_alu_pack_sources_rewrite_their_lines_alone(form):
    """Each form is the production source with E, the CTA size and (for
    the widened form) the int16 form changed, and the production form is
    the source itself."""
    prod = (_build.CSRC / "alu_mix.cu").read_text()
    var = alu_pack.variant_source(*form)
    kind, words, threads = form
    back = var.replace(f"kWords = {words};", "kWords = 4;").replace(
        f"kAluThreads = {threads};", "kAluThreads = 256;")
    if kind == "widened":
        assert "using Form16 = Widened16<MIX>;" in var
        back = back.replace(alu_pack.WIDENED, "").replace(
            "Widened16<MIX>;", "Packed16<MIX>;")
    assert back == prod
    assert (var == prod) == (form == alu_pack.forms()[0])


def test_alu_pack_refuses_unknown_forms():
    with pytest.raises(ValueError):
        alu_pack.variant_source("dense", 4, 256)


def _sass(body_ops, words):
    """A cuobjdump -sass listing of one packed muladd kernel: set-up, an
    outer item loop around the step loop (``body_ops`` an unrolled step and
    word, then its compare and branch), and a smaller scalar step loop."""
    unroll, stride = map(int, alu_pack.UNROLL.search(
        alu_pack.variant_source("packed", words, 256)).groups())
    unroll *= stride
    lines, addr = [], 0

    def put(ins):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {ins} ;"
                     "  /* 0x0000000000000000 */")
        addr += 16

    put("LDC R1, c[0x0][0x28]")
    outer = addr
    put("LDG.E.128 R4, desc[UR6][R2.64]")
    inner = addr
    put("UIADD3 UR4, UR4, 0x1, URZ")
    for _ in range(unroll * words):
        for op in body_ops:
            put(f"{op} R5, R5, R6")
    put("ISETP.NE.AND P0, PT, R4, UR4, PT")
    put(f"@P0 BRA 0x{inner:x}")
    put("STG.E.128 desc[UR6][R2.64], R4")
    put(f"@!P1 BRA 0x{outer:x}")
    scalar = addr
    for _ in range(unroll):
        put(f"{body_ops[0]} R7, R7, R8")
    put(f"@P2 BRA 0x{scalar:x}")
    put("EXIT")
    put(f"BRA 0x{addr:x}")
    name = ("_ZN4bjxa12_GLOBAL__N_114alu_mix_kernelIsNS0_8Packed16ILi2EEEEEv"
            "PKT_PS4_jjjjj")
    return ("\n\tcode for sm_90a\n\t\tFunction : " + name
            + "\n\t.headerflags\t@\"EF_CUDA_SM90\"\n" + "\n".join(lines) + "\n")


@pytest.mark.parametrize("words", [1, 4])
def test_alu_pack_counts_the_step_loop(words):
    body = ["VIADD.16x2", "VIADD.16x2", "VIADD.16x2"]
    got = alu_pack.sass_counts(_sass(body, words), words,
                               alu_pack.variant_source("packed", words, 256))
    assert got == {"int16+muladd": {"per_word_step": 3.0,
                                    "ops": {"VIADD.16x2": 3.0}}}


@pytest.fixture
def tiny_probe(monkeypatch):
    monkeypatch.setenv("BJXA_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_REPS", "1")
    monkeypatch.setattr(probe, "SHAPE", (3, 8))


def test_alu_pack_rehearsal(tiny_probe, capsys):
    """On the CPU the script holds the packed and widened forms' plain twins
    to each other and times them on the host clock: one line a form."""
    recs = alu_pack.main()
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == recs
    assert [(r["form"], r["production"]) for r in recs] == [
        ("packed", True), ("widened", False)]
    for r in recs:
        assert r["metric"] == "alu_pack" and r["device"] == "cpu"
        assert (r["words"], r["threads"]) == (4, 256)
        assert r["graph_ms"] is None and r["sass"] is None
        assert sorted(r["eager_ms"]) == sorted(
            f"{d}+{m}" for d in ("int32", "int16") for m in probe.MIXES)
        assert all(v > 0 for v in r["eager_ms"].values())


def test_alu_pack_needs_the_card_without_the_cpu_variable(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("BJXA_PLATFORM", raising=False)
    with pytest.raises(NoDeviceError):
        alu_pack.main()


def test_alu_probe_bench_rate_from_the_host_clock_on_the_cpu(tiny_probe,
                                                             capsys):
    """The CPU rehearsal of ``--bench`` takes its rates from the host clock:
    no graph time, and the note says how the packed form composes the
    multiply and the shift."""
    recs = probe.bench_int16_vs_int32(reps=1)
    capsys.readouterr()
    rates = [r for r in recs if r["metric"] == "alu_mix_rate"]
    assert len(rates) == 6
    assert all(r["graph_ms"] is None and r["ms"] > 0 for r in rates)
    notes = [r["note"] for r in recs if r["metric"] == "int16_over_int32_rate"]
    assert all("two elements to a 32-bit register" in n for n in notes)
