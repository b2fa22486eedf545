"""A run of each cell, its chip look skipped, at a tiny size on the CPU,
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have. (No cell spans chips, so no exchange
between chips can be left out.)"""

from __future__ import annotations

import torch

import run as runner
from lmbench import cells


def _half_left_out(deploy_forward):
    def broken(sd, x, **kw):
        out = deploy_forward(sd, x[: x.shape[0] // 2], **kw)
        return torch.cat([out, torch.zeros_like(out)])
    return broken


def _answer_altered(deploy_forward):
    def broken(sd, x, **kw):
        return deploy_forward(sd, x, **kw).flip(-1)  # the classes swapped where produced
    return broken


def _serve_verdict(tiny_cell, name, fault):
    from lmnet_tpu_torch.serve import deploy_forward

    _, make = tiny_cell(name)
    faults = {} if fault is None else {"deploy_forward": fault(deploy_forward)}
    res = cells.DRIVERS[make().traffic["kind"]](make(seconds=0.3, faults=faults))
    return runner.verdict(res), res


def test_serve_faults(tiny_cell):
    ok, res = _serve_verdict(tiny_cell, "lmnet-256.serve-b128", None)
    assert ok, res.numbers
    for fault in (_half_left_out, _answer_altered):
        ok, res = _serve_verdict(tiny_cell, "lmnet-256.serve-b128", fault)
        assert not ok, (fault.__name__, res.numbers)


def test_batcher_fault(tiny_cell):
    ok, res = _serve_verdict(tiny_cell, "lmnet-256.batcher-open", _answer_altered)
    assert not ok, res.numbers


def test_train_faults(tiny_cell):
    from lmnet_tpu_torch.train import train_step

    def unchanged(state, images, labels, cm, **kw):
        logits = state.model(images, train=False)
        return state, logits.float().mean().detach(), cm

    def half(state, images, labels, cm, **kw):
        n = images.shape[0] // 2
        return train_step(state, images[:n], labels[:n], cm, **kw)

    _, make = tiny_cell("lmnet-256.train-b128")
    for fault in (unchanged, half):
        res = cells.train(make(seconds=0.3, faults={"train_step": fault}))
        assert not runner.verdict(res), (fault.__name__, res.numbers)
