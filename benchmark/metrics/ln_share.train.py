"""Device time of the hand-written LayerNorm kernels (``csrc/layer_norm.cu``:
``ln_rows_fwd``, ``ln_rows_bwd``, ``ln_rows_bwd_reduce``), matched by name,
as a share of the device's busy time in the traced window. A share and not
a roofline: SegFormer's stage-3 maps sit in the card's 50 MB L2 cache
between the residual add and the next LayerNorm, so bytes over HBM
bandwidth could read above 100 %. None where no such kernel ran (a program
without them)."""

from lmbench import readers

LAYER = "LayerNorm kernels: ops/layer_norm.py, csrc/layer_norm.cu"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"
KERNELS = "ln_rows_"


def read(ctx):
    return readers.share_of_busy(ctx, lambda t: t.kernel_s(lambda n: KERNELS in n))
