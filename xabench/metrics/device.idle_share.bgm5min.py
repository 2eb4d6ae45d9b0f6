"""Share of the traced window of songs through wav_to_xa with nothing running on the card."""

from xabench import readers


def read(ctx):
    return readers.idle_share(ctx)
