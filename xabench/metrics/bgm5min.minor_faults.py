"""Median minor page faults of a song's wav_to_xa call: its root span's minflt (the thread's count at its end less at its start).  None where the program counts none."""

from xabench import program_spans as ps

ROOT = "bjxa.api.wav_to_xa"


def read(ctx):
    return ps.over_calls(ctx, ROOT, lambda c: ps.attr(c, ROOT, "minflt"))
