"""Device time of PyTorch's elementwise, reduction and foreach kernels
(BatchNorm's statistics and normalisation, GELU, the loss, AdamW) as a
share of the device's busy time in the traced window."""

from lmbench import readers

LAYER = "train step's stock passes: BatchNorm, GELU, loss, AdamW"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.share_of_busy(
        ctx, lambda t: t.kernel_s(lambda n: any(k in n for k in readers.ELTWISE)))
