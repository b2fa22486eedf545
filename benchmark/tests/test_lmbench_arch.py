"""The architecture slot (``arch/__init__.py``): a toy architecture defined
here alone (``toy_arch.py``) runs through the serve and train windows and
the controls, which name no architecture, with ``correct`` true, and false
under each fault; LM-Net through the slot gives what ``reference.lmnet``
gives called directly; more than two classes draw label maps in which every
class occurs, and two classes draw what they always did."""

from __future__ import annotations

import sys
import time

import pytest
import torch
import torch.nn.functional as F

import control
import run as runner
import toy_arch
from conftest import TINY
import arch
from lmbench import arith, cells, check, inputs

SEED = 2**31 + 77
# three seeds on the CPU: sound float32 runs read logit_err <= 8e-8, loss and grad1 <=
# 1.2e-7, change 0, bn_stats <= 7e-4; the fp8 control 0.05-0.07, loss 0.0013-0.0032,
# grad1 0.0031-0.012, bn_stats 0.0068-0.016; the half batch loss 0.0052-0.020
TOY_LIMITS = {"logit_err": 1e-3, "loss": 1e-4, "grad1": 1e-4, "change": 1e-3, "bn_stats": 3e-3}


@pytest.fixture
def toy(monkeypatch):
    """``make(kind)`` -> a cell of the toy architecture with the ``kind``
    ('serve', 'train') mix's parameters at a small size, as
    ``run.load_cell`` gives a cell; the toy is ``arch.toy`` meanwhile."""
    import json

    from conftest import BENCH, SMALL

    monkeypatch.setitem(sys.modules, f"arch.{toy_arch.NAME}", toy_arch)

    def make(kind):
        traffic = json.loads((BENCH / "traffic" / f"{kind}-b128.json").read_text())
        traffic = dict(traffic, **SMALL[kind], model={}, deploy={})
        return {"name": f"toy-32.{kind}", "chips": 1, "config": dict(toy_arch.CONFIG),
                "traffic": traffic, "limits": TOY_LIMITS}

    return make


def _run(cell, faults=None, seed=SEED):
    return cells.Run(cell["name"], cell["config"], cell["traffic"], cell["limits"], seed, 0.3,
                     False, torch.device("cpu"), time.perf_counter(), faults or {})


def _half_left_out(mod, x):
    out = mod(x[: x.shape[0] // 2].float())
    return torch.cat([out, torch.zeros_like(out)])


def _answer_altered(mod, x):
    return mod(x.float()).roll(1, dims=-1)  # every class's logit moved to the next class


def test_the_loader_finds_the_configurations_architecture(toy):
    assert arch.name({}) == "lmnet" and arch.load({}).__name__ == "arch.lmnet"
    assert arch.load(toy("serve")["config"]) is toy_arch


def test_toy_serves_correct_and_each_fault_fails(toy):
    cell = toy("serve")
    res = cells.serve(_run(cell))
    assert runner.verdict(res), res.numbers
    assert res.numbers["logit_err"][0] < 1e-5
    for fault in (_half_left_out, _answer_altered):
        res = cells.serve(_run(cell, {"toy_forward": fault}))
        assert not runner.verdict(res), (fault.__name__, res.numbers)


def test_toy_trains_correct_and_each_fault_fails(toy):
    from lmnet_tpu_torch.train import train_step

    def unchanged(state, images, labels, cm, **kw):
        return state, state.model(images, train=False).float().mean().detach(), cm

    def half(state, images, labels, cm, **kw):
        n = images.shape[0] // 2
        return train_step(state, images[:n], labels[:n], cm, **kw)

    cell = toy("train")
    res = cells.train(_run(cell))
    assert runner.verdict(res), res.numbers
    for fault in (unchanged, half):
        res = cells.train(_run(cell, {"train_step": fault}))
        assert not runner.verdict(res), (fault.__name__, res.numbers)


@pytest.mark.parametrize("kind,kinds", [("serve", ("fp8",)), ("train", ("fp8", "half"))])
def test_toy_controls_fail_its_limits(toy, kind, kinds):
    cell = toy(kind)
    out = control.control(cell, SEED, torch.device("cpu"), kinds)
    for k in kinds:
        assert any(v > TOY_LIMITS[n] for n, v in out[k].items() if n in TOY_LIMITS), (k, out[k])


def test_toy_head_shift_centres_the_classes(toy):
    config = toy("serve")["config"]
    raw = arch.weights(config, 3, "cpu")
    x, _ = inputs.images_and_masks(2, 32, inputs.generator(4, "cpu"), "cpu", classes=4)
    shift = cells.centre_margin(config, raw, x)
    assert len(shift) == 4 and abs(sum(shift)) < 1e-5
    mean = check.reference_logits(toy_arch.reference(config, raw), x).mean(dim=(0, 1, 2))
    assert float(mean.max() - mean.min()) < 1e-4


def test_toy_operations_by_hand(toy):
    """Each conv's 2 x outputs x inputs x taps; the head at full size."""
    config = toy("serve")["config"]
    s, w, k = 32, 8, 4
    convs = (s * s * w * 3 * 9 + (s // 2) ** 2 * 2 * w * w * 9 + s * s * w * 2 * w
             + s * s * k * w)
    assert arith.model_flops(config, False) == arith.model_flops(config, True) == 2 * convs


# ---------------------------------------------------------------------------
# LM-Net through the slot


LMNET = {"model": TINY, "image_size": 32, "dtype": "bfloat16"}


def test_lmnet_weights_and_reference_logits_through_the_slot():
    from reference.lmnet import LMNetRef, param_specs

    A = arch.load(LMNET)
    direct = inputs.weights(param_specs(2, TINY["filters"], TINY["num_heads"]), 5, "cpu")
    raw = arch.weights(LMNET, 5, "cpu")
    assert list(raw) == list(direct) and all(torch.equal(raw[k], direct[k]) for k in raw)
    x, _ = inputs.images_and_masks(3, 32, inputs.generator(6, "cpu"), "cpu", torch.bfloat16)
    got = check.reference_logits(A.reference(LMNET, raw), x)
    assert torch.equal(got, check.reference_logits(LMNetRef(direct, TINY["num_heads"]), x))
    low = check.reference_logits(A.reference(LMNET, raw, q=check.fp8_round), x)
    assert torch.equal(low, check.reference_logits(
        LMNetRef(direct, TINY["num_heads"], q=check.fp8_round), x))


@pytest.mark.parametrize("deploy", [{"nat_backend": "flat", "rc_backend": "xla"},
                                    {"nat_backend": "plain", "rc_backend": "xla",
                                     "skip_compose": True, "ln_fold": True}])
def test_lmnet_serving_passes_every_deploy_option(deploy):
    """Every key of a traffic's ``deploy`` reaches ``deploy_forward``, as the
    fault hook that stands in for it sees the call."""
    seen = []
    call = arch.load(LMNET).serve_fn(
        LMNET, {"deploy": deploy}, arch.weights(LMNET, 4, "cpu"),
        {"deploy_forward": lambda variables, x, **kw: seen.append(kw)})
    call(torch.zeros((1, 32, 32, 3)))
    assert seen == [dict(deploy, num_heads=TINY["num_heads"])]


@pytest.mark.parametrize("train", [False, True])
def test_lmnet_operations_through_the_slot(train):
    """The slot's count is the reference's, counted directly, plus NAT's."""
    from torch.utils.flop_counter import FlopCounterMode

    from reference.lmnet import LMNetRef, param_specs

    full = {"model": {"num_classes": 2, "filters": [12, 24, 48, 96, 192], "num_heads": 12},
            "image_size": 256}
    p = {n: torch.zeros(s, device="meta") for n, s, _, _ in param_specs()}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        LMNetRef(p, 12).forward(torch.zeros((1, 256, 256, 3), device="meta"), train=train)
    direct = float(counter.get_total_flops()) + arith.nat_flops_per_image(256, full["model"]
                                                                           ["filters"])
    assert arith.model_flops(full, train) == direct
    assert direct == pytest.approx(10.441e9 if train else 10.087e9, rel=1e-4)


def test_lmnet_train_steps_through_the_slot():
    from reference.lmnet import train_steps

    raw = arch.weights(LMNET, 8, "cpu")
    xs, ys = inputs.pool(2, 2, 32, 9, "cpu", torch.float32)
    traffic = {"optimizer": {"epochs": 200, "steps_per_epoch": 100}}
    got = arch.load(LMNET).train_steps(LMNET, traffic, raw, list(zip(xs, ys)),
                                       inputs.generator(10, "cpu"), batch_slice=slice(0, 1))
    want = train_steps(raw, list(zip(xs, ys)), inputs.generator(10, "cpu"), 32,
                       num_heads=TINY["num_heads"], filters=TINY["filters"],
                       batch_slice=slice(0, 1))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# label maps


def _two_class_draw(n, size, g, device, dtype=torch.float32):
    """The two-class draw as it stood before label maps took more classes."""
    low = torch.rand((n, 1, 8, 8), generator=g, device=device)
    mask_field = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)[:, 0]
    level = 0.35 + 0.4 * torch.rand((n, 1, 1), generator=g, device=device)
    masks = (mask_field > level).to(torch.int32)
    low = torch.rand((n, 3, 8, 8), generator=g, device=device)
    img = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    img = img + 0.5 * masks[:, None].float()
    img = img + 0.1 * torch.randn((n, 3, size, size), generator=g, device=device)
    img = (img - img.mean(dim=(1, 2, 3), keepdim=True)) / img.std(dim=(1, 2, 3), keepdim=True)
    return img.permute(0, 2, 3, 1).contiguous().to(dtype), masks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_classes_draw_bit_for_bit_as_before(dtype):
    xs, ys = inputs.pool(3, 4, 48, 2**31 + 3, "cpu", dtype)
    g = inputs.generator(2**31 + 3, "cpu")
    for x, y in zip(xs, ys):
        x0, y0 = _two_class_draw(4, 48, g, "cpu", dtype)
        assert torch.equal(x, x0) and torch.equal(y, y0)


@pytest.mark.parametrize("classes,batch", [(3, 1), (4, 2), (150, 2)])
def test_more_classes_occur_in_every_batch(classes, batch):
    xs, ys = inputs.pool(3, batch, 64, 2**31 + 4, "cpu", torch.float32, classes)
    xs2, ys2 = inputs.pool(3, batch, 64, 2**31 + 4, "cpu", torch.float32, classes)
    for x, y, x2, y2 in zip(xs, ys, xs2, ys2):
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert y.dtype == torch.int32 and y.shape == (batch, 64, 64)
        counts = torch.bincount(y.flatten().long(), minlength=classes)
        assert len(counts) == classes and (counts > 0).all()
        # each class about its share of the batch's pixels (ties of the field move a few)
        share = y.numel() / classes
        assert counts.min() >= 0.5 * share and counts.max() <= 1.5 * share
    assert not torch.equal(ys[0], ys[1])
