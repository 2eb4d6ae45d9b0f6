"""Inputs from the seed: the files of a configuration, as a traffic mix
asks for them.

A configuration (``configs/<name>.json``) fixes the files' shapes: sample
rate, channel counts, bit depths, and either a fixed frame count or a range
of block counts, with the signal's parameters.  A traffic mix
(``traffic/<name>.json``) says how many files, of which formats, and how
they are fed.  :func:`file_specs` lays the files on a fixed grid of those
shapes, the same for every seed; the seed only orders them and makes their
content (:func:`signal`), so two seeds ask the same work of the program.
XA inputs are made here, by the reference's search (never by the program).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

from xabench import reference as ref


@dataclasses.dataclass(frozen=True)
class FileSpec:
    """One input file: its place in the grid, its shape and its name."""

    index: int
    channels: int
    bits: int
    frames: int
    rate: int

    @property
    def blocks(self) -> int:
        return -(-self.frames // ref.BLOCK_SAMPLES)

    @property
    def name(self) -> str:
        return f"{self.index:05d}_{self.channels}ch_{self.bits}b"

    @property
    def xa_bytes(self) -> int:
        """Payload bytes of its XA form."""
        return self.blocks * self.channels * ref.block_size(self.bits)

    @property
    def pcm_bytes(self) -> int:
        return self.frames * self.channels * 2


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed and names."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def file_specs(config: dict, traffic: dict, seed: int) -> list[FileSpec]:
    """The traffic's files, in the order the seed gives them.

    File ``i`` takes format ``i % F`` of the formats (channel counts x bit
    depths; an encode mix fixes the bits) and, where the configuration
    gives a range of block counts, a length on an even grid over that
    range within each format; the trailing partial block follows a fixed
    grid too.  The seed permutes the list.
    """
    bits = [traffic["bits"]] if "bits" in traffic else config["bits"]
    formats = [(c, b) for c in config["channels"] for b in bits]
    F = len(formats)
    n = traffic["files_per_format"] * F
    per = -(-n // F)
    specs = []
    for i in range(n):
        c, b = formats[i % F]
        if "frames" in config:
            frames = config["frames"]
        else:
            lo, hi = config["blocks"]
            blocks = lo + (i // F) * (hi - lo + 1) // per
            frames = blocks * ref.BLOCK_SAMPLES - (i * 13) % ref.BLOCK_SAMPLES
        specs.append(FileSpec(i, c, b, frames, config["sample_rate"]))
    g = torch.Generator().manual_seed(subseed(seed, "order"))
    return [specs[j] for j in torch.randperm(n, generator=g).tolist()]


def signal(spec: FileSpec, sig: dict, seed: int, device) -> torch.Tensor:
    """The int16 ``[frames, channels]`` content of one file: tones plus
    noise plus clipping transients, per ``sig`` (the configuration's
    ``signal``), made on ``device`` from the seed."""
    g = torch.Generator(device=device).manual_seed(
        subseed(seed, "signal", spec.index))
    C, T = spec.channels, spec.frames

    def u(*shape):
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float64)

    k = sig["tones"]
    lo, hi = (math.log(f) for f in sig["tone_hz"])
    freq = torch.exp(lo + (hi - lo) * u(k, C))
    amp = sig["tone_amplitude"] * (0.25 + 0.75 * u(k, C)) / k
    phase = 2 * math.pi * u(k, C)
    t = torch.arange(T, device=device, dtype=torch.float64)[:, None]
    x = torch.zeros((T, C), dtype=torch.float64, device=device)
    for j in range(k):
        x += amp[j] * torch.sin(2 * math.pi * freq[j] * t / spec.rate
                                + phase[j])
    x += sig["noise_amplitude"] * (2 * u(T, C) - 1)
    # transients: short bursts driven past full scale, then clipped
    period = int(sig["transient_every_s"] * spec.rate)
    width = max(1, int(sig["transient_s"] * spec.rate))
    starts = torch.arange(0, T, max(period, 1), device=device)
    starts = starts + (u(starts.numel()) * max(period - width, 1)).long()
    for s in starts.tolist():
        seg = x[s:s + width]
        seg *= sig["transient_gain"]
    return (x * 32767).round().clamp(-32768, 32767).to(torch.int16)


def make_pcm(specs, sig: dict, seed: int, device) -> list[torch.Tensor]:
    """Every file's content, on ``device``."""
    return [signal(s, sig, seed, device) for s in specs]


def make_xa(specs, pcms) -> list[bytes]:
    """The XA images of the files, searched by the reference in one
    open-loop pass a bit depth (:func:`xabench.reference.encode_open_loop`).
    """
    out = [None] * len(specs)
    for bits in sorted({s.bits for s in specs}):
        idx = [i for i, s in enumerate(specs) if s.bits == bits]
        pays = ref.encode_open_loop([pcms[i] for i in idx], bits)
        for i, pay in zip(idx, pays):
            s = specs[i]
            out[i] = ref.xa_image(pay, s.frames, s.rate, s.bits)
    return out
