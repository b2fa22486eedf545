"""Share of the traced window in which nothing ran on the card (the
profiler's kernels, copies and sets, merged)."""

from lmbench import readers

LAYER = "device: the H100's timeline (torch.profiler)"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_pct(ctx)
