"""The deploy graph's operations a image (counted on the reference) times
the images served in the untraced stretch of the window, over its seconds,
as a share of the card's bf16 tensor-core peak."""

from lmbench import readers

LAYER = "whole forward: serve/engine.py::deploy_forward"
UNIT = "%"
MOVES = "serve_img_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.mfu(ctx, train=False)
