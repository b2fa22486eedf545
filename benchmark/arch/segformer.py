"""SegFormer: the port's ``models/segformer.py::SegFormer`` on one side, the
plain ``reference/segformer.py`` on the other (``arch/__init__.py`` says
what this module gives the harness).

The configuration's ``model`` holds ``num_classes``, ``embed_dims``,
``num_heads``, ``depths``, ``sr_ratios``, ``mlp_ratio``, ``decoder_dim``,
``drop_path`` and ``dropout``: ``SegFormer``'s keyword arguments. A
traffic's ``model`` (training) or ``deploy`` (serving) holds more of them (an
unknown key is an error). Serving is the model's eval forward; its fault
hook is ``faults["segformer_forward"]``, called as ``segformer_forward(model,
x)``.
"""

from __future__ import annotations

import torch

from lmbench import arith
from reference import segformer as ref


def param_specs(config: dict):
    return ref.param_specs(config["model"])


def _model(config: dict, options: dict):
    from lmnet_tpu_torch.models import SegFormer

    return SegFormer(**config["model"], dtype=getattr(torch, config["dtype"]), **options)


def serve_fn(config: dict, traffic: dict, raw: dict, faults: dict):
    """``SegFormer``'s eval forward on ``raw``."""
    model = _model(config, traffic.get("deploy", {})).to(next(iter(raw.values())).device).eval()
    model.load_state_dict(raw, strict=True)
    fn = faults.get("segformer_forward", lambda mod, x: mod(x))
    return lambda x: fn(model, x)


def train_model(config: dict, traffic: dict) -> torch.nn.Module:
    return _model(config, traffic["model"])


def train_kwargs(config: dict) -> dict:
    """``num_classes``: uniform CE and Dice weights (``train_step``'s
    ``_weights``)."""
    return {"num_classes": config["model"]["num_classes"]}


def reference(config: dict, raw: dict, q=None):
    return ref.SegFormerRef(raw, config["model"], q=q)


def train_steps(config: dict, traffic: dict, raw: dict, batches, generator, q=None,
                batch_slice=slice(None)):
    opt = traffic["optimizer"]
    return ref.train_steps(raw, batches, generator, config["model"], q=q, epochs=opt["epochs"],
                           steps_per_epoch=opt["steps_per_epoch"], batch_slice=batch_slice)


def head_shift(logits: torch.Tensor):
    """Every class's mean logit onto the mean over the classes."""
    c = logits.mean(dim=(0, 1, 2))
    return "linear_pred.bias", -(c - c.mean())


def forward_flops(config: dict, train: bool) -> float:
    """Counted on the reference (its convs, linears and the attention's two
    products, which it writes as matrix products); the same graph in both
    modes."""
    size = config["image_size"]
    p = {name: torch.zeros(shape, device="meta") for name, shape, _, _ in param_specs(config)}
    x = torch.zeros((1, size, size, 3), device="meta")
    model = ref.SegFormerRef(p, config["model"])
    return arith.counted_flops(lambda: model.forward(x, train=train))


def attention_flops(config: dict) -> float:
    """The attention's products of one image's forward: 4 N M C a block
    (q k^T and the weighted sum of v, 2 operations a multiply-add), N the
    stage's tokens, M the reduced ones, C its width."""
    m, size = config["model"], config["image_size"]
    total, side = 0, size
    for i, (dim, depth, sr) in enumerate(zip(m["embed_dims"], m["depths"], m["sr_ratios"])):
        side = (side + 3) // 4 if i == 0 else (side + 1) // 2
        n, r = side * side, side // sr
        total += depth * 4 * n * r * r * dim
    return float(total)


def bn_elements(config: dict) -> int:
    """The head's BatchNorm input elements of one image: the fused
    ``decoder_dim`` channels over c1's grid (the stage-1 patch embedding's,
    stride 4)."""
    side = (config["image_size"] + 3) // 4
    return side * side * config["model"]["decoder_dim"]
