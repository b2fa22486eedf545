"""B1's share of its roofline in the traced window: the least time of a
batch's four NAT forwards (q, k, v in and the output out once at HBM
bandwidth) times the traced batches, over the device time of
``nat_fwd_kernel``."""

from lmbench import arith, readers

LAYER = "NAT kernel B1: ops/nat_flat.py, csrc/nat_fwd.cu"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    m = ctx.config["model"]
    size = ctx.config["image_size"]
    return readers.roofline(ctx, ("nat_fwd_kernel",), lambda b: arith.nat_fwd_bound_s(
        b, size, m["filters"], m["num_heads"], 2))
