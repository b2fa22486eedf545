"""Device time of the kernels launched inside the program's
``segformer.attn`` spans (``models/segformer.py::Block``: a block's first
LayerNorm, the reduction conv and its LayerNorm, q, kv, SDPA, proj, drop
path and the residual add; 52 a forward at MiT-B5) as a share of the
device's busy time in the traced window. The spans hold the forward alone:
the backward's kernels are launched by the autograd engine outside them.
None where the trace holds no ``segformer.*`` span (a program without
them)."""

from lmbench import readers

LAYER = ("MiT efficient self-attention by span (segformer.attn): "
         "models/segformer.py::EfficientSelfAttention")
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("segformer.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: op == "segformer.attn"))
