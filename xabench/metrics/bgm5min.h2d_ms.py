"""Median ms of a song's wav_to_xa span bjxa.ops.h2d: the padded PCM copied to the card."""

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa",
                         lambda c: c.ms(("bjxa.ops.h2d",)))
