"""Device time of the kernels launched inside the program's
``segformer.ffn`` spans (``models/segformer.py::Block``: a block's second
LayerNorm, fc1, the depthwise 3x3 conv, GELU, fc2, drop path and the
residual add; 52 a forward at MiT-B5) as a share of the device's busy time
in the traced window; the forward alone, as ``mit_attn_share.train``. None
where the trace holds no ``segformer.*`` span."""

from lmbench import readers

LAYER = "MiT Mix-FFN by span (segformer.ffn): models/segformer.py::MixFFN"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("segformer.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: op == "segformer.ffn"))
