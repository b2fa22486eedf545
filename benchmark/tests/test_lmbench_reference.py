"""The frozen reference against the port's plain backends at a tiny size on
the CPU: the names and shapes of the state dict, the deploy graph, and
three float32 train steps."""

from __future__ import annotations

import pytest
import torch

from conftest import TINY
from lmbench import check, inputs
from reference.lmnet import LMNetRef, param_specs


@pytest.mark.parametrize("model", [{}, TINY], ids=["full", "tiny"])
def test_specs_are_the_ports_state_dict(model):
    from lmnet_tpu_torch.models import LMNet

    m = dict({"num_classes": 2, "filters": [12, 24, 48, 96, 192], "num_heads": 12}, **model)
    sd = LMNet(num_classes=2, filters=tuple(m["filters"]), num_heads=m["num_heads"]).state_dict()
    specs = param_specs(2, m["filters"], m["num_heads"])
    assert [(n, tuple(s)) for n, s, _, _ in specs] == [(k, tuple(v.shape)) for k, v in sd.items()]
    if not model:
        assert sum(torch.Size(s).numel() for n, s, _, _ in specs
                   if not n.endswith(("running_mean", "running_var"))) == 3966566


def test_weights_repeat_from_the_seed_and_cover_every_entry():
    specs = param_specs(2, TINY["filters"], TINY["num_heads"])
    a, b = inputs.weights(specs, 7, "cpu"), inputs.weights(specs, 7, "cpu")
    c = inputs.weights(specs, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    assert all(a[k].std() > 0 for k in a if a[k].numel() > 1)
    assert (a["conv1.0.expand_conv.1.running_var"] >= 0.5).all()


@pytest.mark.parametrize("size", [32, 48])
def test_deploy_graph_against_the_port(size):
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward

    raw = inputs.weights(param_specs(2, TINY["filters"], TINY["num_heads"]), 3, "cpu")
    x, _ = inputs.images_and_masks(3, size, inputs.generator(4, "cpu"), "cpu")
    ref = check.reference_logits(LMNetRef(raw, TINY["num_heads"]), x)
    with torch.no_grad():
        got = deploy_forward(structural_reparam(raw), x, num_heads=TINY["num_heads"],
                             nat_backend="plain")
    assert check.logit_err(got, ref) < 1e-5


def test_train_steps_against_the_port(tiny_cell):
    """The port's float32 train_step driven by the harness, held by the
    cell's own comparison: every number at float32 rounding (the change
    after Adam's first steps, which scale each element's gradient to about
    one, to 1e-2: an element whose gradient is near 0 takes a step of
    either sign)."""
    from lmbench import cells

    cell, make = tiny_cell("lmnet-256.train-b128")
    cell["config"]["dtype"] = "float32"
    res = cells.train(make(seconds=0.5))
    nums = {k: v for k, (v, _, _) in res.numbers.items()}
    assert nums["loss"] < 1e-5 and nums["grad1"] < 1e-3 and nums["change"] < 1e-2
    assert nums["bn_stats"] < 1e-2


def test_dropout_masks_are_the_ports():
    """The masks the reference draws are the ones the port's blocks draw
    from an equal generator, in the same order."""
    from lmnet_tpu_torch.models import LMNet
    from reference.lmnet import draw_masks

    model = LMNet(num_classes=2, filters=tuple(TINY["filters"]), num_heads=TINY["num_heads"])
    g1 = torch.Generator().manual_seed(9)
    drawn = []
    orig = torch.rand

    def spy(*a, **k):
        out = orig(*a, **k)
        drawn.append(out)
        return out

    torch.rand = spy
    try:
        model(torch.zeros(2, 32, 32, 3), train=True, generator=g1)
    finally:
        torch.rand = orig
    masks = draw_masks(2, 32, torch.Generator().manual_seed(9), "cpu", TINY["filters"])
    ours = [m for pair in masks.values() for m in pair]
    assert len(ours) == len(drawn)
    assert all(torch.equal(a, b < 0.9) for a, b in zip(ours, drawn))
