"""Median ms a song's wav_to_xa call spends before the card: the spans bjxa.format.parse_riff, bjxa.format.load_pcm (the body's copy into the staging buffer) and bjxa.api.pad of one call, summed."""

from xabench import program_spans as ps

STAGES = ("bjxa.format.parse_riff", "bjxa.format.load_pcm", "bjxa.api.pad")


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa", lambda c: c.ms(STAGES))
