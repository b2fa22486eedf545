"""The profile reader on a synthetic Chrome trace: the window, the busy and
idle time, kernel sums, op-to-kernel shares and what the host did in each
idle gap."""

from __future__ import annotations

import pytest

from lmbench import profile, readers


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 100, "dur": 100,
           "tid": 1}]
    # host thread 1: conv2d [105, 130] > cudnn_convolution [106, 128] > launch at 110;
    # add [140, 150] > launch at 141; item [155, 190] (the host waits)
    ev += [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 105, "dur": 25, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution", "ts": 106, "dur": 22,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 140, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 141, "dur": 2,
         "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 155, "dur": 35, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 2,
         "tid": 1, "args": {"correlation": 3}},
    ]
    # device: conv kernel [115, 135], elementwise [145, 160], an op before the window [60, 110]
    ev += [
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop", "ts": 115, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>",
         "ts": 145, "dur": 15, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 50,
         "args": {"correlation": 3}},
    ]
    return ev


def test_window_busy_idle_and_sums():
    t = profile.from_events(_events())
    assert t.window_s == pytest.approx(100e-6)
    # busy: [100, 110] of the copy, [115, 135], [145, 160]
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.kernel_s(lambda n: "elementwise" in n) == pytest.approx(15e-6)
    assert t.under_host_s(lambda op: "conv" in op) == pytest.approx(20e-6)
    assert t.top_ops(2) == [["sm90_xmma_fprop", pytest.approx(20e-6)],
                            ["void at::native::vectorized_elementwise_kernel<4>",
                             pytest.approx(15e-6)]]


def test_idle_gaps_by_host():
    t = profile.from_events(_events())
    gaps = [(a, b) for a, b, _ in t.idle_gaps()]
    assert gaps == [(110, 115), (135, 145), (160, 200)]
    named = dict(t.idle_by_host())
    # [110, 115]: mid 112.5 inside cudnn_convolution; [135, 145]: mid 140 inside add
    assert named["aten::cudnn_convolution"] == pytest.approx(5e-6)
    assert named["aten::add"] == pytest.approx(10e-6)
    assert named["end of window"] == pytest.approx(40e-6)


def test_host_stack_nests():
    t = profile.from_events(_events())
    assert t.host_stack(1, 111) == ("cudaLaunchKernel", "aten::cudnn_convolution",
                                    "aten::conv2d", profile.WINDOW)
    assert t.host_stack(1, 135) == (profile.WINDOW,)
    assert t.host_stack(2, 135) == ()


def test_readers_on_the_trace():
    t = profile.from_events(_events())
    ctx = readers.Context({}, {"images": 30, "untraced": (10, 1.0), "batch": 10}, trace=t)
    assert readers.idle_pct(ctx) == pytest.approx(55.0)
    assert readers.share_of_busy(ctx, lambda tr: tr.under_host_s(lambda op: "conv" in op)) \
        == pytest.approx(100 * 20 / 45)
    # two traced batches, each bounded at 5 us, against 20 us of the kernel
    assert readers.roofline(ctx, ("fprop",), lambda b: 5e-6) == pytest.approx(50.0)
    assert readers.roofline(ctx, ("absent_kernel",), lambda b: 5e-6) is None
    assert readers.idle_pct(readers.Context({}, {}, trace=None)) is None


def test_no_window_annotation_raises():
    with pytest.raises(ValueError):
        profile.from_events(_events()[1:])
