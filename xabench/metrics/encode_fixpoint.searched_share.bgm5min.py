"""Mean over a song's wav_to_xa calls of the share of the search fixed point's item-rounds that it searched: the span bjxa.ops.search's searched / (items x rounds).  None where the program counts no searched items."""

import statistics

from xabench import program_spans as ps


def _share(call):
    got = [ps.attr(call, "bjxa.ops.search", k)
           for k in ("searched", "items", "rounds")]
    if None in got or not got[1] or not got[2]:
        return None
    searched, items, rounds = got
    return searched / (items * rounds)


def read(ctx):
    return ps.over_calls(ctx, "bjxa.api.wav_to_xa", _share, statistics.fmean)
