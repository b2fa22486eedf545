"""The train-mode BatchNorm kernels' share of their byte roofline in
SegFormer's training cell: the least time of a step's one BatchNorm, the
all-MLP head's (``arch/segformer.py::bn_elements``: 768 channels over c1's
256^2 grid at 1024^2), whose forward reads x and writes y once and whose
backward reads dy and x and writes dx once, in the configuration's dtype,
at HBM bandwidth, times the traced steps, over the device time of the
``bn_train_*`` kernels (``csrc/bn_train.cu``), matched by name: the train
step replays them from CUDA graphs. None where the kernels did not run (a
program without them)."""

import torch

from lmbench import arith, readers

LAYER = "train-mode BatchNorm kernels: ops/bn_train.py, csrc/bn_train.cu"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None:
        return None
    import arch

    elem = torch.finfo(getattr(torch, ctx.config["dtype"])).bits // 8
    per_image = 5 * elem * arch.load(ctx.config).bn_elements(ctx.config)
    return readers.roofline(ctx, ("bn_train_",), lambda b: b * per_image / arith.HBM_RATE)
