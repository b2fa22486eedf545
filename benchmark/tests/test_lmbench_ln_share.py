"""``ln_share.train`` on a hand-written trace: the ``ln_rows_`` kernels'
device time over busy time, None without them, and none of their names
among the stock passes ``eltwise_share.train`` counts."""

from __future__ import annotations

import pytest

from lmbench import profile, readers

LN_NAMES = ("void (anonymous namespace)::ln_rows_fwd<__nv_bfloat16, 8, 1>(...)",
            "void (anonymous namespace)::ln_rows_bwd<__nv_bfloat16, 8, 2>(...)",
            "(anonymous namespace)::ln_rows_bwd_reduce(float const*, float*, int, int)")


def _reader():
    import run

    return run.metric_reader("ln_share.train")


def _trace(kernels):
    """A 100 us window with (name, start, duration) kernels in it."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 100, "dur": 100,
           "tid": 1}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur,
            "args": {"correlation": i}} for i, (n, ts, dur) in enumerate(kernels)]
    return profile.from_events(ev)


def test_the_share_of_busy_time():
    t = _trace([(LN_NAMES[0], 110, 10), (LN_NAMES[1], 125, 20), (LN_NAMES[2], 150, 5),
                ("void at::native::vectorized_elementwise_kernel<4>", 160, 15)])
    ctx = readers.Context({}, {"images": 8, "untraced": (0, 0.0), "batch": 8}, trace=t)
    assert _reader().read(ctx) == pytest.approx(100 * 35 / 50)


def test_none_without_the_kernels_or_a_trace():
    t = _trace([("void at::native::vectorized_layer_norm_kernel<c10::BFloat16>", 110, 10),
                ("void at::native::reduce_kernel<512, 1>", 125, 20)])
    m = _reader()
    assert m.read(readers.Context({}, {}, trace=t)) is None
    assert m.read(readers.Context({}, {}, trace=None)) is None


def test_no_ln_kernel_counts_as_a_stock_pass():
    assert not any(k in n for n in LN_NAMES for k in readers.ELTWISE)
