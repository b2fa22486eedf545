"""Three times the train-mode forward's operations a image (counted on the
reference: forward and backward, no recompute counted) times the images
trained in the untraced stretch of the window, over its seconds, as a
share of the card's bf16 tensor-core peak."""

from lmbench import readers

LAYER = "whole step: train/engine.py::train_step"
UNIT = "%"
MOVES = "train_img_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.mfu(ctx, train=True)
