"""Median ms of a song's wav_to_xa span bjxa.ops.readback: the host waiting for the search and deflate, then the blocks copied back."""

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa",
                         lambda c: c.ms(("bjxa.ops.readback",)))
