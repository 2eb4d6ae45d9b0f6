"""Median wav_to_xa latency of a song in the untraced window."""

from xabench import readers


def read(ctx):
    return readers.latency_ms(ctx, 50)
