"""Segmentation losses on NHWC logits.

Counterpart of ``lmnet_tpu/losses/losses.py``: the losses the port's
training and serving paths use (``cross_entropy_loss``, ``dice_loss`` and
their sum ``segmentation_loss``, the live training criterion). Logits are
``(B, H, W, C)``; integer labels are ``(B, H, W)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _class_weights(weight: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """``weight`` as a tensor of ``like``'s dtype and device, made by fill
    kernels on the device: ``torch.tensor(weight, device=...)`` and
    ``w[i] = value`` copy from the host, which synchronises the host with a
    CUDA device at every step."""
    return torch.stack([torch.full((), float(w), dtype=like.dtype, device=like.device)
                        for w in weight])


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Sequence[float] | None = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss`` semantics (class weights + label
    smoothing) on NHWC logits.

    Per pixel: l_n = -sum_c t_nc * w_c * log p_nc with
    t = (1-eps)*onehot + eps/C; the reduction is sum(l_n) / sum(w_{y_n}),
    torch's weighted mean over the target-class weights.
    """
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(labels.long(), num_classes).to(logp.dtype)
    target = one_hot
    if label_smoothing > 0.0:
        target = (1.0 - label_smoothing) * one_hot + label_smoothing / num_classes
    if weight is None:
        return -(target * logp).sum(dim=-1).mean()
    w = _class_weights(weight, logp)
    per_pixel = -(target * w * logp).sum(dim=-1)
    return per_pixel.sum() / (one_hot * w).sum()


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Sequence[float] | None = None,
    smooth: float = 1e-5,
) -> torch.Tensor:
    """The reference DiceLoss (square-sum denominator) on softmax
    probabilities, sums over the whole batch:

    dice_c = (2 * sum(s * t) + smooth) / (sum(s^2) + sum(t^2) + smooth),
    loss = sum_c weight_c * (1 - dice_c) / C.
    """
    num_classes = logits.shape[-1]
    probs = F.softmax(logits, dim=-1)
    target = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    dims = (0, 1, 2)
    intersect = (probs * target).sum(dim=dims)
    y_sum = (target * target).sum(dim=dims)
    z_sum = (probs * probs).sum(dim=dims)
    dice = (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    w = _class_weights([1.0] * num_classes if weight is None else weight, probs)
    return (w * (1.0 - dice)).sum() / num_classes


def segmentation_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ce_weight: Sequence[float] | None = (1.0, 4.0),
    dice_weight: Sequence[float] | None = (1.0, 4.0),
    label_smoothing: float = 0.001,
) -> torch.Tensor:
    """The live LM-Net training criterion: weighted label-smoothed CE plus
    weighted square-denominator Dice."""
    return cross_entropy_loss(logits, labels, ce_weight, label_smoothing) + dice_loss(
        logits, labels, dice_weight
    )
