"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import pytest

from lmbench import arith
from reference.lmnet import param_specs

FULL = {"num_classes": 2, "filters": [12, 24, 48, 96, 192], "num_heads": 12}


def test_nat_stages_and_bounds():
    assert arith.nat_stages(256, FULL["filters"]) == [(32, 32, 96), (64, 64, 48),
                                                      (128, 128, 24), (256, 256, 12)]
    per_image = 32 * 32 * 96 + 64 * 64 * 48 + 128 * 128 * 24 + 256 * 256 * 12
    assert per_image == 1_474_560
    assert arith.nat_flops_per_image(256, FULL["filters"]) == 36 * per_image
    # B=128 bf16: q, k, v, out once = 4 x 2 bytes an element
    assert arith.nat_fwd_bound_s(128, 256, FULL["filters"], 12, 2) == pytest.approx(
        4 * 2 * 128 * per_image / 3.35e12)
    assert arith.nat_bwd_bound_s(128, 256, FULL["filters"], 12, 2) == pytest.approx(
        7 * 2 * 128 * per_image / 3.35e12)
    # in float32 at a tiny batch the operations bound: 36 an element, 36 a pixel-head
    pix = 32 * 32 + 64 * 64 + 128 * 128 + 256 * 256
    assert arith.nat_fwd_bound_s(1, 256, FULL["filters"], 12, 4) == pytest.approx(
        max(16 * per_image / 3.35e12, (36 * per_image + 36 * pix * 12) / 67e12))


def test_model_flops_count_the_branch_convs_by_hand():
    """The train-mode graph differs from the deploy graph by each
    ReparamConv's four branch convs (5x5 + 3x3 + 3x1 + 1x3 = 40 taps)
    against its folded 5x5 (25): 2 x H x W x E x 15 a block."""
    size = 64
    config = {"model": FULL, "image_size": size}
    deploy, train = arith.model_flops(config, False), arith.model_flops(config, True)
    f = FULL["filters"]
    # (map side divisor, expand width) of the 16 blocks, two a stage
    stages = [(1, f[1]), (2, f[2]), (4, f[3]), (8, f[4]),
              (8, f[4]), (4, f[3]), (2, f[2]), (1, f[1])]
    extra = sum(2 * 2 * (size // d) ** 2 * e * 15 for d, e in stages)
    assert train - deploy == extra


def test_model_flops_hand_count_of_the_head():
    """The 1x1 head alone: 2 x H x W x 12 x 2 of the 256^2 count."""
    specs = {n: s for n, s, _, _ in param_specs()}
    assert specs["output_layer.weight"] == (2, 12, 1, 1)
    total = arith.model_flops({"model": FULL, "image_size": 256}, False)
    assert total > 2 * 256 * 256 * 12 * 2
    assert total == pytest.approx(10.0866e9, rel=1e-4)
