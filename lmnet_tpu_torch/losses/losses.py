"""Segmentation losses on NHWC logits.

Counterpart of ``lmnet_tpu/losses/losses.py``; only the loss the serving
path reports is ported here. Logits are ``(B, H, W, C)``; integer labels are
``(B, H, W)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


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
    w = torch.as_tensor(weight, dtype=logp.dtype, device=logp.device)
    per_pixel = -(target * w * logp).sum(dim=-1)
    return per_pixel.sum() / (one_hot * w).sum()
