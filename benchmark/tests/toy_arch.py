"""A toy architecture for the harness's tests, in the shape of
``arch/<arch>.py`` (``arch/__init__.py`` says what it gives): a small conv
segmentation net with BatchNorm, its train-mode module on the port's side
(``ToyNet``, trained by the port's ``train.train_step``) and its own plain
reference (``ToyRef``), which shares nothing with it but the recipe of
``reference/train.py``.

The net, NHWC in and out: a 3x3 conv stem with BatchNorm and ReLU, a 3x3
stride-2 conv with BatchNorm and ReLU, a bilinear 2x upsample and a 1x1
conv added to the stem's output, a 1x1 head. ``NAME`` is the architecture's
name; a test puts this module in ``sys.modules`` as ``arch.<NAME>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lmbench import arith
from reference import train as recipe

NAME = "toy"
BN_EPS = 1e-5
CONFIG = {"name": "toy-32", "arch": NAME, "model": {"num_classes": 4, "width": 8},
          "image_size": 32, "dtype": "float32"}
# (name, kernel, stride, input, output) of each conv; a BatchNorm follows 'stem' and 'down'
CONVS = (("stem", 3, 1, "in", "w"), ("down", 3, 2, "w", "2w"), ("up", 1, 1, "2w", "w"),
         ("head", 1, 1, "w", "classes"))
NORMED = ("stem", "down")


def _widths(config: dict) -> dict:
    m = config["model"]
    return {"in": 3, "w": m["width"], "2w": 2 * m["width"], "classes": m["num_classes"]}


def param_specs(config: dict):
    c = _widths(config)
    out = []
    for name, k, _, cin, cout in CONVS:
        fan = c[cin] * k * k
        out += [(f"{name}.weight", (c[cout], c[cin], k, k), "w", fan),
                (f"{name}.bias", (c[cout],), "b", fan)]
        if name in NORMED:
            out += [(f"{name}_bn.{key}", (c[cout],), kind, 1) for key, kind in (
                ("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                ("running_var", "bn_var"))]
    return out


# ---------------------------------------------------------------------------
# the program's side


class _BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=train, momentum=recipe.BN_MOMENTUM, eps=BN_EPS)


class ToyNet(nn.Module):
    """The toy in torch modules; ``forward(x, train, generator)`` as the
    port's ``train_step`` calls a model (no dropout: the generator is not
    drawn from)."""

    def __init__(self, config: dict):
        super().__init__()
        c = _widths(config)
        for name, k, stride, cin, cout in CONVS:
            setattr(self, name, nn.Conv2d(c[cin], c[cout], k, stride, k // 2))
            if name in NORMED:
                setattr(self, f"{name}_bn", _BatchNorm(c[cout]))

    def forward(self, x, train: bool = False, generator=None):
        h1 = F.relu(self.stem_bn(self.stem(x.permute(0, 3, 1, 2)), train))
        h2 = F.relu(self.down_bn(self.down(h1), train))
        h = self.up(F.interpolate(h2, scale_factor=2, mode="bilinear")) + h1
        return self.head(h).permute(0, 2, 3, 1).float()


def serve_fn(config: dict, traffic: dict, raw: dict, faults: dict):
    """``ToyNet`` in eval mode on ``raw``, float32; the fault hook
    ``faults["toy_forward"]`` is called as ``toy_forward(model, x)``."""
    model = ToyNet(config).to(next(iter(raw.values())).device).eval()
    model.load_state_dict(raw, strict=True)
    fn = faults.get("toy_forward", lambda mod, x: mod(x.float()))
    return lambda x: fn(model, x)


def train_model(config: dict, traffic: dict) -> nn.Module:
    return ToyNet(config)


def train_kwargs(config: dict) -> dict:
    return {"num_classes": config["model"]["num_classes"]}


# ---------------------------------------------------------------------------
# the plain reference


class ToyRef:
    """The toy as functions of a state dict ``p``, NHWC, every weight and
    activation rounded by ``q``; the train-mode forward records each
    BatchNorm's batch mean and unbiased variance in ``stats``."""

    def __init__(self, p: dict, q=None):
        self.p, self.q = p, q or (lambda t: t)
        self.stats = []

    def conv(self, x, name, stride):
        w = self.q(self.p[f"{name}.weight"])
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.q(self.p[f"{name}.bias"]), stride,
                     w.shape[-1] // 2)
        return self.q(y.permute(0, 2, 3, 1))

    def bn(self, x, name, train):
        if train:
            n = x.numel() // x.shape[-1]
            mean = x.mean(dim=(0, 1, 2))
            var = (x - mean).square().mean(dim=(0, 1, 2))
            self.stats.append((name, mean.detach(), var.detach() * n / (n - 1)))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * self.q(self.p[f"{name}.weight"])
        return self.q(y + self.q(self.p[f"{name}.bias"]))

    def forward(self, x, train: bool = False):
        x = self.q(x.float())
        h1 = self.q(F.relu(self.bn(self.conv(x, "stem", 1), "stem_bn", train)))
        h2 = self.q(F.relu(self.bn(self.conv(h1, "down", 2), "down_bn", train)))
        up = F.interpolate(h2.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear")
        h = self.q(self.conv(self.q(up.permute(0, 2, 3, 1)), "up", 1) + h1)
        return self.conv(h, "head", 1).float()


def reference(config: dict, raw: dict, q=None):
    return ToyRef(raw, q)


def train_steps(config: dict, traffic: dict, raw: dict, batches, generator, q=None,
                batch_slice=slice(None)):
    def forward(state, x):
        model = ToyRef(state, q)
        return model.forward(x[batch_slice], True), model.stats

    opt = traffic["optimizer"]
    return recipe.train_steps(raw, batches, forward, (1.0,) * config["model"]["num_classes"],
                              opt["epochs"], opt["steps_per_epoch"], batch_slice)



def head_shift(logits: torch.Tensor):
    """Every class's mean logit onto the mean over the classes."""
    c = logits.mean(dim=(0, 1, 2))
    return "head.bias", -(c - c.mean())


def forward_flops(config: dict, train: bool) -> float:
    size = config["image_size"]
    p = {name: torch.zeros(shape, device="meta") for name, shape, _, _ in param_specs(config)}
    x = torch.zeros((1, size, size, 3), device="meta")
    return arith.counted_flops(lambda: ToyRef(p).forward(x, train))
