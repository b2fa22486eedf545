"""B2's share of its roofline in the traced window: the least time of a
step's four NAT backwards (q, k, v and the output's gradient in, dq, dk,
dv out once at HBM bandwidth) times the traced steps, over the device time
of ``nat_bwd_kernel`` and ``nat_bwd_dbias_reduce``."""

from lmbench import arith, readers

LAYER = "NAT kernel B2: ops/nat_flat.py, csrc/nat_bwd.cu"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "device_trace"


def read(ctx):
    m = ctx.config["model"]
    size = ctx.config["image_size"]
    return readers.roofline(ctx, ("nat_bwd_kernel", "nat_bwd_dbias_reduce"),
                            lambda b: arith.nat_bwd_bound_s(b, size, m["filters"],
                                                            m["num_heads"], 2))
