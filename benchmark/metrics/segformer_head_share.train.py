"""Device time of the kernels launched inside the program's
``segformer.head`` span (``models/segformer.py::SegFormer.head``: the four
Linears, their resizes, the concat, the 3072 -> 768 fuse, BatchNorm, ReLU,
Dropout2d, the class Linear and the logits' resize to the input; one a
forward) as a share of the device's busy time in the traced window; the
forward alone, as ``mit_attn_share.train``. None where the trace holds no
``segformer.*`` span."""

from lmbench import readers

LAYER = "SegFormer all-MLP head by span (segformer.head): models/segformer.py::SegFormer.head"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("segformer.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: op == "segformer.head"))
