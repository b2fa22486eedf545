"""The training recipe every architecture's plain reference shares, in
plain PyTorch, float32: the loss, AdamW, the cosine schedule and the loop of
checked steps that ``train.train_step`` runs on any model.

It imports nothing of the program. An architecture's reference
(``reference/<arch>.py``) gives the loop its train-mode forward.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.1  # running = 0.9 running + 0.1 batch


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, weight,
                      smoothing: float = 0.001, smooth: float = 1e-5) -> torch.Tensor:
    """Class-weighted, label-smoothed cross-entropy (torch's weighted mean:
    the sum of per-pixel losses over the sum of the target classes'
    weights) plus the class-weighted square-denominator Dice over the
    batch."""
    C = logits.shape[-1]
    w = torch.tensor(weight, dtype=torch.float32, device=logits.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), C).float()
    target = (1.0 - smoothing) * onehot + smoothing / C
    ce = -(target * w * logp).sum() / (onehot * w).sum()
    probs = logp.exp()
    inter = (probs * onehot).sum(dim=(0, 1, 2))
    dice = (2 * inter + smooth) / (probs.square().sum(dim=(0, 1, 2))
                                   + onehot.sum(dim=(0, 1, 2)) + smooth)
    return ce + (w * (1.0 - dice)).sum() / C


def cosine_lr(step: int, base: float = 1e-3, epochs: int = 200, steps_per_epoch: int = 100,
              eta_min: float = 1e-6) -> float:
    """Cosine annealing stepped once an epoch, at global step ``step``."""
    epoch = min(step // steps_per_epoch, epochs)
    return eta_min + (base - eta_min) * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))


class AdamW:
    """AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay) on a dict
    of float32 tensors."""

    def __init__(self, params: dict, weight_decay: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.wd, self.betas, self.eps = params, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))


def is_param(name: str) -> bool:
    """A trained leaf (a BatchNorm's running statistics are not)."""
    return not name.endswith(("running_mean", "running_var"))


def train_steps(p: dict, batches, forward: Callable, weight, epochs: int, steps_per_epoch: int,
                batch_slice=slice(None)):
    """Train the float32 copy of ``p`` for one step on each (images, labels)
    of ``batches``: ``forward(state, images)`` gives the train-mode logits
    of ``images[batch_slice]`` and the BatchNorm statistics it used, as
    (name, mean, variance for the running update); then the loss with the
    class weights ``weight``, its gradient, AdamW at the cosine schedule's
    rate over ``epochs`` of ``steps_per_epoch``, the running statistics
    moved toward the batch's. Returns (the losses, the first step's
    gradients, the state after the last step), all on p's device."""
    state = {k: v.detach().clone().float() for k, v in p.items()}
    params = {k: v.requires_grad_() for k, v in state.items() if is_param(k)}
    opt = AdamW(params, weight_decay=1e-4)
    losses, first = [], None
    for step, (x, y) in enumerate(batches):
        logits, stats = forward(state, x)
        loss = segmentation_loss(logits, y[batch_slice], weight)
        del logits
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads, cosine_lr(step, epochs=epochs, steps_per_epoch=steps_per_epoch))
        with torch.no_grad():
            for name, mean, var in stats:
                rm, rv = state[f"{name}.running_mean"], state[f"{name}.running_var"]
                rm.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                rv.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        del stats, grads, loss
    return losses, first, {k: v.detach() for k, v in state.items()}
