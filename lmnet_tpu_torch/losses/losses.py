"""Segmentation losses on NHWC logits.

Counterpart of ``lmnet_tpu/losses/losses.py``, all twelve functions, with
the reference's semantics (``utils/loss.py``, ``train.py``):

  dice_loss            : DiceLoss (:170-206), square-sum denominator,
                         smooth 1e-5, class weights, optional ignore mask
  cross_entropy_loss   : torch CrossEntropyLoss with class weights and
                         label smoothing (train.py:157)
  segmentation_loss    : the live training criterion, CE + weighted Dice
  bce_dice_loss        : BCEDiceLoss (:6-28)
  focal_loss           : the modulator-form sigmoid focal loss (:29-58)
  sigmoid_focal_loss   : torchvision's sigmoid_focal_loss (:135-137)
  focal_loss_per_class : class FocalLoss (:126-148)
  effective_number_weights, class_balanced_loss : (:59-125)
  mmseg_binary_dice_loss, mmseg_dice_loss, official_dice_loss : (:210-267)

Logits are ``(B, H, W, C)``; integer labels ``(B, H, W)``.

Inside a data-parallel step (``parallel/batch.py::global_batch``) the
training loss is JAX's loss of the global batch: the Dice sums over (B, H,
W) and the weighted CE's numerator and denominator are summed over the
ranks (``global_sum``) before the ratios. The other losses are not on the
train step and compute over the rows they are given.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lmnet_tpu_torch.parallel.batch import active, global_sum


def _class_weights(weight: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """``weight`` as a tensor of ``like``'s dtype and device, made by fill
    kernels on the device: ``torch.tensor(weight, device=...)`` and
    ``w[i] = value`` copy from the host, which synchronises the host with a
    CUDA device at every step."""
    return torch.stack([torch.full((), float(w), dtype=like.dtype, device=like.device)
                        for w in weight])


def _one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(dtype)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x t + log1p(exp(-|x|)), elementwise."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def cross_entropy_terms(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Sequence[float] | None = None,
    label_smoothing: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The numerator and denominator of ``cross_entropy_loss`` over these
    rows: sum(l_n) and sum(w_{y_n}) (the pixel count without ``weight``).
    Summed over the ranks of a data-parallel batch, their ratio is the
    global batch's loss."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    one_hot = _one_hot(labels, num_classes, logp.dtype)
    target = one_hot
    if label_smoothing > 0.0:
        target = (1.0 - label_smoothing) * one_hot + label_smoothing / num_classes
    if weight is None:
        per_pixel = -(target * logp).sum(dim=-1)
        return per_pixel.sum(), torch.full((), float(per_pixel.numel()), device=logp.device)
    w = _class_weights(weight, logp)
    return -(target * w * logp).sum(dim=-1).sum(), (one_hot * w).sum()


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
    num, den = cross_entropy_terms(logits, labels, weight, label_smoothing)
    if active():
        num, den = global_sum(torch.stack([num, den]))
    return num / den


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Sequence[float] | None = None,
    softmax: bool = True,
    ignore: torch.Tensor | None = None,
    smooth: float = 1e-5,
) -> torch.Tensor:
    """The reference DiceLoss (square-sum denominator), sums over the whole
    batch:

    dice_c = (2 * sum(s * t) + smooth) / (sum(s^2) + sum(t^2) + smooth),
    loss = sum_c weight_c * (1 - dice_c) / C,

    s the softmax probabilities (``logits`` themselves without ``softmax``).
    ``ignore``: an optional (B, H, W) mask; pixels where it is 1 drop out.
    """
    num_classes = logits.shape[-1]
    probs = F.softmax(logits, dim=-1) if softmax else logits
    target = _one_hot(labels, num_classes, probs.dtype)
    if ignore is not None:
        keep = (ignore != 1).to(probs.dtype)[..., None]
        probs = probs * keep
        target = target * keep
    dims = (0, 1, 2)
    intersect = (probs * target).sum(dim=dims)
    y_sum = (target * target).sum(dim=dims)
    z_sum = (probs * probs).sum(dim=dims)
    if active():
        intersect, y_sum, z_sum = global_sum(torch.stack([intersect, y_sum, z_sum]))
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


def bce_dice_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """The reference BCEDiceLoss: 0.4 * CE + 0.6 * (1 - dice), the dice with
    a linear denominator, averaged over (image, class)."""
    num_classes = logits.shape[-1]
    ce = cross_entropy_loss(logits, labels)
    probs = F.softmax(logits, dim=-1)
    target = _one_hot(labels, num_classes, probs.dtype)
    inter = (probs * target).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + target.sum(dim=(1, 2))
    dice = ((2.0 * inter + eps) / (union + eps)).mean()
    return 0.4 * ce + 0.6 * (1.0 - dice)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha, gamma: float = 2.0):
    """The modulator-form sigmoid focal loss. ``labels`` are multi-hot floats
    of logits' shape; ``alpha`` broadcasts as a per-example weight. The sum
    is divided by sum(labels)."""
    bce = _bce_with_logits(logits, labels)
    if gamma == 0.0:
        modulator = 1.0
    else:
        modulator = torch.exp(-gamma * labels * logits
                              - gamma * torch.log1p(torch.exp(-logits)))
    return (alpha * modulator * bce).sum() / labels.sum()


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """torchvision's ``sigmoid_focal_loss``: BCE(logits, t) * (1 - p_t)^gamma,
    alpha-balanced when alpha >= 0; reduction 'mean', 'sum' or anything
    else for none."""
    p = torch.sigmoid(logits)
    bce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = bce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def focal_loss_per_class(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """The reference's class FocalLoss: the sum over classes c of the mean
    sigmoid focal loss of the class-c logit map against (labels == c)."""
    loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    for c in range(logits.shape[-1]):
        target_c = (labels == c).to(torch.float32)
        loss = loss + sigmoid_focal_loss(logits[..., c], target_c, alpha, gamma, "mean")
    return loss


def effective_number_weights(samples_per_class: Sequence[float], beta: float = 0.9999,
                             device=None) -> torch.Tensor:
    """Class-balanced 'effective number' weights, (1 - beta) / (1 - beta^n)
    normalised to sum to the class count; float64 numpy arithmetic, the
    result float32 (on ``device``)."""
    spc = np.asarray(samples_per_class, dtype=np.float64)
    effective = 1.0 - np.power(beta, spc)
    w = (1.0 - beta) / (effective + 1e-8)
    w = w / w.sum() * len(spc)
    return torch.as_tensor(w.astype(np.float32), device=device)


def class_balanced_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    samples_per_class: Sequence[float],
    beta: float = 0.9999,
    gamma: float = 2.0,
    loss_type: str = "focal",
) -> torch.Tensor:
    """The class-balanced loss on (N, C) logits and integer labels (N,):
    'focal', 'sigmoid' (weighted BCE on the logits) or 'softmax' (weighted
    BCE on the clipped softmax probabilities)."""
    num_classes = logits.shape[-1]
    w = effective_number_weights(samples_per_class, beta, logits.device)
    one_hot = _one_hot(labels, num_classes)
    wn = w[labels.long()][:, None]
    if loss_type == "focal":
        return focal_loss(logits, one_hot, wn, gamma)
    if loss_type == "sigmoid":
        return (wn * _bce_with_logits(logits, one_hot)).mean()
    probs = torch.clamp(F.softmax(logits, dim=-1), 1e-12, 1.0 - 1e-12)
    bce = -(one_hot * torch.log(probs) + (1.0 - one_hot) * torch.log(1.0 - probs))
    return (wn * bce).mean()


def mmseg_binary_dice_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid_mask: torch.Tensor,
    smooth: float = 1.0,
    exponent: float = 2.0,
) -> torch.Tensor:
    """mmseg's per-sample binary dice: 1 - (2 sum(p t m) + smooth) /
    (sum(p^e + t^e) + smooth) over each sample's flattened maps; the
    denominator is not masked (as in the reference). Returns (B,)."""
    b = pred.shape[0]
    p = pred.reshape(b, -1)
    t = target.reshape(b, -1).to(p.dtype)
    m = valid_mask.reshape(b, -1).to(p.dtype)
    num = 2.0 * (p * t * m).sum(dim=1) + smooth
    den = (p ** exponent + t ** exponent).sum(dim=1) + smooth
    return 1.0 - num / den


def mmseg_dice_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid_mask: torch.Tensor,
    smooth: float = 1.0,
    exponent: float = 2.0,
    class_weight: Sequence[float] | None = None,
    ignore_index: int = 255,
) -> torch.Tensor:
    """mmseg's multi-class dice: ``pred`` (B, H, W, C) probabilities,
    ``target`` (B, H, W, C) one-hot, ``valid_mask`` (B, H, W). A class whose
    index is ``ignore_index`` is skipped; the per-class dice is weighted,
    summed and divided by C. Returns (B,)."""
    num_classes = pred.shape[-1]
    total = torch.zeros((pred.shape[0],), dtype=pred.dtype, device=pred.device)
    for i in range(num_classes):
        if i == ignore_index:
            continue
        d = mmseg_binary_dice_loss(pred[..., i], target[..., i], valid_mask, smooth, exponent)
        if class_weight is not None:
            d = d * class_weight[i]
        total = total + d
    return total / num_classes


def official_dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smooth: float = 1.0,
    exponent: float = 2.0,
    class_weight: Sequence[float] | None = None,
    loss_weight: float = 1.0,
    ignore_index: int = 255,
) -> torch.Tensor:
    """The reference's ``offical_DiceLoss``: softmax over classes, one-hot
    of the clamped labels, valid mask labels != ``ignore_index``, mmseg dice
    summed over the batch, times ``loss_weight``."""
    num_classes = logits.shape[-1]
    probs = F.softmax(logits, dim=-1)
    one_hot = _one_hot(torch.clamp(labels, 0, num_classes - 1), num_classes)
    valid_mask = (labels != ignore_index).to(torch.int32)
    per_sample = mmseg_dice_loss(probs, one_hot, valid_mask, smooth, exponent, class_weight,
                                 ignore_index)
    return loss_weight * per_sample.sum()
