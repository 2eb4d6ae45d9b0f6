"""The traced window's arithmetic (``xabench/trace.py``) on a made-up
trace: the window is the requests' time, busy time is the device's within
it, and each idle gap is named by the host range open at its middle."""

from __future__ import annotations

import pytest

from xabench import trace as tr

HOST = [
    (0.0, 10.0, tr.WINDOW, None),
    (1.0, 3.0, "xabench.api.xa_to_wav", None),
    (1.2, 1.5, "aten::copy_", None),
    (5.0, 8.0, "xabench.api.xa_to_wav", None),
]
DEVICE = [
    (1.5, 2.0, "decode_stream_kernel", "kernel"),
    (2.0, 2.5, "Memcpy DtoH", "gpu_memcpy"),
    (4.0, 4.5, "reference_kernel", "kernel"),  # between requests
    (7.0, 9.0, "decode_stream_kernel", "kernel"),  # runs past its request
]


def test_window_is_the_requests_time():
    s = tr._summary(DEVICE, HOST)
    assert s["window_s"] == pytest.approx(5.0)
    assert s["busy_s"] == pytest.approx(1.0 + 1.0)
    assert s["kernel_s"] == pytest.approx(0.5 + 0.5 + 2.0)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # gaps 1.0-1.5 (its middle in aten::copy_), 2.5-3.0 and 5.0-7.0
    assert gaps == pytest.approx({"aten::copy_": 0.5,
                                  "xabench.api.xa_to_wav": 0.5 + 2.0})


def test_no_request_no_window():
    s = tr._summary(DEVICE, HOST[:1])
    assert s["window_s"] == 0 and s["busy_s"] == 0
