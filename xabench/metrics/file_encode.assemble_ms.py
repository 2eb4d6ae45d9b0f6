"""Median ms of a wav_to_xa call's span bjxa.api.assemble: the payload's bytes, the header and the XA image."""

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa",
                     lambda c: c.ms(("bjxa.api.assemble",)))
