"""Device time of the kernels launched inside the program's ``lmnet.natt``
spans (``serve/engine.py::deploy_forward``: the four NeighborhoodTransformer
blocks whole, patch embedding, LayerNorms, qkv, B1, proj and MLP) as a share
of the device's busy time in the traced window. None where the trace holds
no ``lmnet.*`` span (a program without them)."""

from lmbench import readers

LAYER = "NATT blocks by span (lmnet.natt): serve/engine.py::_natt"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not any(h.startswith("lmnet.") for d in ctx.trace.device
                                    for h in d.host):
        return None
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: op == "lmnet.natt"))
