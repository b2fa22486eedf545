"""The per-layer metrics that read the program's ``lmnet.*`` spans, on
Chrome traces written by hand: left out (None) on a trace without such
spans, as on a program that has none; exact shares and counts on a trace
with nested spans and a backward thread."""

from __future__ import annotations

import pytest

from lmbench import profile, readers

SERVE = ("rc_block_share.serve", "natt_share.serve", "fold_launches.serve")
TRAIN = ("fwd_share.train", "recompute_share.train")


def _reader(name):
    import run

    return run.metric_reader(name)


def _window():
    return [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 100,
             "dur": 100, "tid": 1}]


def _span(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _ctx(events, images=30, untraced=10, batch=10):
    return readers.Context({}, {"images": images, "untraced": (untraced, 1.0), "batch": batch},
                           trace=profile.from_events(events))


def _no_spans():
    """aten ops alone around the launches, as the parent program's trace."""
    return _window() + [
        _span("aten::conv2d", 105, 20, cat="cpu_op"), _launch(110, 1),
        _span("aten::add", 140, 10, cat="cpu_op"), _launch(141, 2),
        _kernel("sm90_xmma_fprop", 115, 20, 1), _kernel("elementwise_kernel", 145, 15, 2),
    ]


def _served():
    """One thread: lmnet.rc [105, 130] holding lmnet.fold [106, 109] (a cast
    launched at 107) and a conv launched at 112; lmnet.natt [135, 150]
    launching at 140; lmnet.head [155, 160] launching at 156."""
    return _window() + [
        _span("lmnet.rc", 105, 25), _span("lmnet.fold", 106, 3),
        _span("aten::to", 106.5, 2, cat="cpu_op"), _launch(107, 1),
        _span("aten::conv2d", 111, 5, cat="cpu_op"), _launch(112, 2),
        _span("lmnet.natt", 135, 15), _launch(140, 3),
        _span("lmnet.head", 155, 5), _launch(156, 4),
        _kernel("elementwise_kernel", 108, 5, 1),  # [108, 113]
        _kernel("sm90_xmma_fprop", 114, 10, 2),  # [114, 124]
        _kernel("nat_fwd_kernel", 141, 20, 3),  # [141, 161]
        _kernel("conv2d_c1_k1", 162, 5, 4),  # [162, 167]
    ]


def _trained():
    """The main thread runs lmnet.step.forward [100, 130] (lmnet.rc [102, 120]
    launching at 105) and lmnet.step.backward [135, 195], which launches at
    140 itself; the autograd engine's thread 2 runs the recompute's lmnet.rc
    [150, 170] (a launch at 155) and a gradient kernel outside it at 175."""
    return _window() + [
        _span("lmnet.step.forward", 100, 30), _span("lmnet.rc", 102, 18), _launch(105, 1),
        _span("lmnet.step.backward", 135, 60), _launch(140, 2),
        _span("lmnet.rc", 150, 20, tid=2), _launch(155, 3, tid=2),
        _span("ConvolutionBackward0", 174, 3, tid=2, cat="cpu_op"), _launch(175, 4, tid=2),
        _kernel("bn_stats", 106, 10, 1),  # [106, 116]
        _kernel("dice_grad", 141, 5, 2),  # [141, 146]
        _kernel("grouped_direct_conv", 156, 8, 3),  # [156, 164]
        _kernel("wgrad_implicit_gemm", 176, 12, 4),  # [176, 188]
    ]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_left_out_without_the_programs_spans(name):
    reader = _reader(name)
    assert reader.read(_ctx(_no_spans())) is None
    assert reader.read(readers.Context({}, {"images": 30, "untraced": (10, 1.0), "batch": 10},
                                       trace=None)) is None


def test_serving_shares_and_fold_launches():
    ctx = _ctx(_served())
    assert ctx.trace.busy_s() == pytest.approx(40e-6)  # 113-108 + 124-114 + 167-141
    assert _reader("rc_block_share.serve").read(ctx) == pytest.approx(100 * 15 / 40)
    assert _reader("natt_share.serve").read(ctx) == pytest.approx(100 * 20 / 40)
    # one launch under lmnet.fold in 2 traced batches of 10 images
    assert _reader("fold_launches.serve").read(ctx) == pytest.approx(0.5)
    assert _reader("fold_launches.serve").read(_ctx(_served(), images=50)) == pytest.approx(0.25)


def test_fold_launches_read_zero_where_spans_run_and_no_fold_launches():
    events = [e for e in _served() if e["name"] != "lmnet.fold"]
    assert _reader("fold_launches.serve").read(_ctx(events)) == 0
    assert _reader("rc_block_share.serve").read(_ctx(events)) == pytest.approx(100 * 15 / 40)


def test_training_forward_and_recompute_shares():
    ctx = _ctx(_trained())
    assert ctx.trace.busy_s() == pytest.approx(35e-6)
    # the forward's kernel alone; the backward thread's lmnet.rc is not under it
    assert _reader("fwd_share.train").read(ctx) == pytest.approx(100 * 10 / 35)
    # the recompute's kernel on thread 2, not the forward's lmnet.rc nor the
    # gradient kernel outside any lmnet.rc
    assert _reader("recompute_share.train").read(ctx) == pytest.approx(100 * 8 / 35)


def test_recompute_left_out_without_a_recompute():
    events = [e for e in _trained() if not (e["name"] == "lmnet.rc" and e["tid"] == 2)]
    assert _reader("recompute_share.train").read(_ctx(events)) is None
    assert _reader("fwd_share.train").read(_ctx(events)) == pytest.approx(100 * 10 / 35)
