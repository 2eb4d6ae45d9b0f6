"""Share of the traced wav_to_xa window with nothing running on the card."""

from xabench import readers


def read(ctx):
    return readers.idle_share(ctx)
