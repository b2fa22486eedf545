"""Device time of the kernels launched inside the program's
``lmnet.step.forward`` spans (``train/engine.py::train_step``: the
train-mode forward, BatchNorm's batch statistics and the dropout draws
included) as a share of the device's busy time in the traced window. None
where the trace holds no ``lmnet.*`` span (a program without them)."""

from lmbench import readers

LAYER = "train forward by span (lmnet.step.forward): models/lm_net.py::LMNet.forward"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("lmnet.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(
        ctx, lambda t: t.under_host_s(lambda op: op == "lmnet.step.forward"))
