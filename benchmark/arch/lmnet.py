"""LM-Net, the architecture of every configuration without an ``"arch"``
key: the port's ``LMNet`` and ``serve.deploy_forward`` on one side, the
plain ``reference/lmnet.py`` on the other (``arch/__init__.py`` says what
this module gives the harness).

The configuration's ``model`` holds ``num_classes``, ``filters`` and
``num_heads``; a serving traffic's ``deploy`` the keyword arguments of
``deploy_forward`` (``nat_backend``, ``rc_backend``; an unknown key is an
error); a training traffic's ``model`` the keyword arguments of ``LMNet``
(``nat_backend``, ``rc_remat``, ``rc_train_backend``). The serving fault
hook is ``faults["deploy_forward"]``, called as ``deploy_forward``.
"""

from __future__ import annotations

import torch

from lmbench import arith
from reference import lmnet as ref


def param_specs(config: dict):
    m = config["model"]
    return ref.param_specs(m["num_classes"], m["filters"], m["num_heads"])


def serve_fn(config: dict, traffic: dict, raw: dict, faults: dict):
    """``deploy_forward`` on the ``structural_reparam`` of ``raw``."""
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward

    deploy = structural_reparam(raw)
    opts = traffic["deploy"]
    heads = config["model"]["num_heads"]
    fn = faults.get("deploy_forward", deploy_forward)

    def call(x):
        return fn(deploy, x, num_heads=heads, **opts)

    return call


def train_model(config: dict, traffic: dict) -> torch.nn.Module:
    from lmnet_tpu_torch.models import LMNet

    m = config["model"]
    return LMNet(num_classes=m["num_classes"], filters=tuple(m["filters"]),
                 num_heads=m["num_heads"], dtype=getattr(torch, config["dtype"]),
                 **traffic["model"])


def train_kwargs(config: dict) -> dict:
    """None: ``train_step``'s defaults are LM-Net's (2 classes, weights 1 and 4)."""
    return {}


def reference(config: dict, raw: dict, q=None):
    return ref.LMNetRef(raw, config["model"]["num_heads"], q=q)


def train_steps(config: dict, traffic: dict, raw: dict, batches, generator, q=None,
                batch_slice=slice(None)):
    m, opt = config["model"], traffic["optimizer"]
    return ref.train_steps(raw, batches, generator, config["image_size"], q=q,
                           num_heads=m["num_heads"], filters=m["filters"], epochs=opt["epochs"],
                           steps_per_epoch=opt["steps_per_epoch"], batch_slice=batch_slice)


def head_shift(logits: torch.Tensor):
    """Half the mean margin between the two classes, onto each class's bias
    with opposite signs."""
    m = float((logits[..., 1] - logits[..., 0]).mean())
    return "output_layer.bias", torch.tensor([m / 2, -m / 2], device=logits.device)


def forward_flops(config: dict, train: bool) -> float:
    """Counted on the reference (its four branch convs a ReparamConv block in
    the train-mode graph, the folded 5x5 in the deploy graph), plus NAT's
    products, which are no conv or matrix product: ``arith.nat_flops_per_image``."""
    m, size = config["model"], config["image_size"]
    p = {name: torch.zeros(shape, device="meta") for name, shape, _, _ in param_specs(config)}
    x = torch.zeros((1, size, size, 3), device="meta")
    model = ref.LMNetRef(p, m["num_heads"])
    return (arith.counted_flops(lambda: model.forward(x, train=train))
            + arith.nat_flops_per_image(size, m["filters"]))
