"""Device time of the kernels launched inside the program's ``lmnet.rc``
spans (``serve/engine.py::deploy_forward``: the 16 ReparamConv blocks, their
weight folds included) as a share of the device's busy time in the traced
window: the span-based measure of the layer that ``conv_share.serve``
measures from the outside. None where the trace holds no ``lmnet.*`` span
(a program without them)."""

from lmbench import readers

LAYER = "ReparamConv blocks by span (lmnet.rc): serve/engine.py::_rc"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("lmnet.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: op == "lmnet.rc"))
