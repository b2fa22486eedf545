"""The control of each cell's check: the reference in the precision below
the configuration's bf16 (float8 e4m3, scaled a tensor), and for training
the half-batch fault, held by the cell's own comparison against the
float32 reference, fail the cell's limits. On the CPU at a small size;
at the cell's own size on the card (``-m gpu``)."""

from __future__ import annotations

import pytest
import torch

import control
import run as runner

CELLS = ["lmnet-256.serve-b128", "lmnet-512.serve-b128", "lmnet-256.train-b128"]


def _fails(cell, numbers) -> bool:
    return any(v > cell["limits"][k] for k, v in numbers.items() if k in cell["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_fails_the_limits_small(name, tiny_cell):
    cell, _ = tiny_cell(name, size=64, filters=[12, 24, 48, 96, 192], num_heads=12)
    if cell["traffic"]["kind"] == "train":
        cell["traffic"]["batch"] = 2
    nums = control.control(cell, 2**31 + 99, torch.device("cpu"))["fp8"]
    assert _fails(cell, nums), nums


def test_half_batch_fault_fails_the_limits_small(tiny_cell):
    cell, _ = tiny_cell("lmnet-256.train-b128", size=64, filters=[12, 24, 48, 96, 192],
                        num_heads=12)
    nums = control.control(cell, 2**31 + 98, torch.device("cpu"), ("half",))["half"]
    assert _fails(cell, nums), nums


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_fails_the_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    cell = runner.load_cell(name)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        nums = control.control(cell, seed, torch.device("cuda"))["fp8"]
        assert _fails(cell, nums), nums
