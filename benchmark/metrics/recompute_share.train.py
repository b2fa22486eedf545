"""Device time of the kernels launched inside an ``lmnet.rc`` span and not
inside ``lmnet.step.forward``: the ReparamConv blocks run again in the
backward under ``rc_remat`` (``models/blocks.py::ReparamConv``, the span
inside the function the checkpoint recomputes; on the card on the autograd
engine's thread), as a share of the device's busy time in the traced
window. None where the trace holds no ``lmnet.*`` span (a program without
them) or nothing was recomputed."""

from lmbench import readers

LAYER = ("ReparamConv recompute by span (lmnet.rc in the backward): "
         "models/blocks.py::ReparamConv")
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def _recomputed(trace) -> float:
    return sum(d.dur for d in trace.device
               if "lmnet.rc" in d.host and "lmnet.step.forward" not in d.host) / 1e6


def read(ctx):
    if ctx.trace is None or not any(h.startswith("lmnet.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, _recomputed)
