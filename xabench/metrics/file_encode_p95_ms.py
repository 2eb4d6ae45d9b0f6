"""95th percentile of every wav_to_xa call's latency in the window."""

from xabench import readers


def read(ctx):
    return readers.latency_ms(ctx, 95)
