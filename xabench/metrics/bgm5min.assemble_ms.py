"""Median ms of a song's wav_to_xa span bjxa.api.assemble: the header and the payload made into the XA image."""

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa",
                         lambda c: c.ms(("bjxa.api.assemble",)))
