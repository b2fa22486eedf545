"""Device time of the kernels launched inside a host convolution op
(``aten::conv2d``, ``aten::convolution``, ``aten::cudnn_convolution``, ...)
as a share of the device's busy time in the traced window: the ReparamConv
blocks' convs and every other conv of the deploy graph."""

from lmbench import readers

LAYER = "ReparamConv blocks and convs: serve/engine.py::_rc, _conv"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.share_of_busy(ctx, lambda t: t.under_host_s(lambda op: "conv" in op))
