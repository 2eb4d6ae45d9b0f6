"""The work counts of the rooflines, exact at small shapes."""

from __future__ import annotations

import pytest

from xabench import work
from xabench.gen import FileSpec


def test_decode_work_counts_payload_pcm_and_samples():
    # 10 blocks stereo 6-bit: 10*2*25 XA bytes, 300 frames * 2 * 2 PCM
    # bytes, 10*32*2 samples of 13 operations
    s = FileSpec(0, 2, 6, 300, 44100)
    assert work.decode_work([s]) == (500 + 1200, 640 * 13)
    m = FileSpec(1, 1, 4, 33, 44100)  # 2 blocks mono 4-bit
    assert work.decode_work([s, m]) == (1700 + 2 * 17 + 66,
                                        (640 + 64) * 13)


def test_encode_work_counts_one_search_of_every_block():
    s = FileSpec(0, 2, 6, 300, 44100)
    assert work.encode_work([s]) == (1700, 640 * 80 * 15)


@pytest.mark.parametrize("nbytes,ops,bound", [(3_350_000, 0, "bytes"),
                                               (0, 33_500_000, "operations"),
                                               (3_350_000, 33_500_000,
                                                "bytes")])
def test_least_time_picks_the_larger_bound(nbytes, ops, bound):
    t, by = work.least_time(nbytes, ops)
    assert by == bound
    assert t == pytest.approx(1e-6)
