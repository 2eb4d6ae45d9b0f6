"""Mean rounds of the search's chunk fixed point a song's wav_to_xa call (the span bjxa.ops.search's rounds)."""

import statistics

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa", lambda c: ps.attr(
        c, "bjxa.ops.search", "rounds"), statistics.fmean)
