"""The train-mode BatchNorm kernels' share of their byte roofline in the
traced window: the least time of a step's BatchNorms at HBM bandwidth (each
forward reads x and writes y once, each backward reads dy and x and writes dx
once, in the configuration's dtype) times the traced steps, over the device
time of the ``bn_train_*`` kernels (``csrc/bn_train.cu``).

The elements are counted once, on the plain reference's train-mode forward
(``reference/lmnet.py``) on meta tensors, so the count does not depend on what
implements the model: the 16 ReparamConv blocks' expand BatchNorm and four
branch BatchNorms, and the four skips' one. Which of them run the kernels, and
how often, comes from the cell's traffic (``model.rc_train_backend``,
``model.rc_remat``): 'auto', 'xla' and 'packed' send all of them through the
kernels, 'fused' only the expand and skip BatchNorms (B6 takes the branches'
statistics); ``rc_remat`` True runs a block's BatchNorms forward twice (the
forward and the recompute in the backward), 'branches' the four branch ones
alone, False none; the skips' run once. The traffic is the cell's
(``ctx.traffic``). None where the kernels did not run (a program without
them), or for a traffic this reader cannot count."""

from __future__ import annotations

import functools

import torch

from lmbench import arith, readers

LAYER = "train-mode BatchNorm kernels: ops/bn_train.py, csrc/bn_train.cu"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


@functools.lru_cache(maxsize=None)
def bn_elements(size: int, filters: tuple, heads: int, classes: int) -> tuple[int, int, int]:
    """(blocks' expand, blocks' branch, skips') BatchNorm input elements of one
    image's train-mode forward on the reference."""
    from reference.lmnet import LMNetRef, param_specs

    counts = {"expand": 0, "branch": 0, "skip": 0}

    class Counted(LMNetRef):
        def bn(self, x, name, train, stats=None):
            if train:
                kind = ("skip" if ".fuse_conv." in name
                        else "expand" if ".expand_conv." in name else "branch")
                counts[kind] += x.numel()
            return super().bn(x, name, train, stats)

    p = {name: torch.zeros(shape, device="meta")
         for name, shape, _, _ in param_specs(classes, filters, heads)}
    with torch.no_grad():
        Counted(p, heads).forward(torch.zeros((1, size, size, 3), device="meta"), train=True)
    return counts["expand"], counts["branch"], counts["skip"]


# forwards a step of (expand, branch) BatchNorms by rc_remat
REMAT_FORWARDS = {True: (2, 2), "full": (2, 2), "branches": (1, 2), False: (1, 1)}
KERNEL_BACKENDS = ("auto", "xla", "packed", "fused")


def bytes_per_image(config: dict, remat, backend: str) -> float:
    """The least bytes a trained image's kernel BatchNorms move in a step."""
    m = config["model"]
    expand, branch, skip = bn_elements(config["image_size"], tuple(m["filters"]),
                                       m["num_heads"], m["num_classes"])
    if backend == "fused":
        branch = 0
    elem = torch.finfo(getattr(torch, config["dtype"])).bits // 8
    fe, fb = REMAT_FORWARDS[remat]
    forwards = fe * expand + fb * branch + skip
    return elem * (2 * forwards + 3 * (expand + branch + skip))


def read(ctx):
    if ctx.trace is None:
        return None
    model = ctx.traffic.get("model", {})
    remat, backend = model.get("rc_remat", True), model.get("rc_train_backend", "auto")
    if remat not in REMAT_FORWARDS or backend not in KERNEL_BACKENDS:
        return None
    per_image = bytes_per_image(ctx.config, remat, backend)
    return readers.roofline(ctx, ("bn_train_",), lambda b: b * per_image / arith.HBM_RATE)
