"""Median ms of a wav_to_xa call's root span bjxa.api.wav_to_xa that none of its stage spans covers."""

from xabench import program_spans as ps


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa", ps.Call.unspanned_ms)
