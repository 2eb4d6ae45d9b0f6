"""Share of the card's roofline at songs (the fixed point at 4,096 chunks): least time of one search of every block of the traced window's wav_to_xa calls over all its kernel time."""

from xabench import readers


def read(ctx):
    return readers.roofline(ctx, "encode")
