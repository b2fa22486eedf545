"""Confusion-matrix metrics, accumulated on the device.

Counterpart of ``lmnet_tpu/metrics/confusion.py`` (``confusion_matrix``,
``derived_metrics``, ``ConfusionAccumulator``). The per-epoch state is one
(C, C) matrix on the device; the host reads it once at the end. Counts are
int64, so they stay exact at any dataset size.
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix; rows = target class, cols = predicted."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def derived_metrics(cm: torch.Tensor, task: str = "binary") -> dict[str, torch.Tensor]:
    """accuracy, precision, recall, specificity, dice, iou, mean_iou from one
    confusion matrix, as the JAX package (torchmetrics semantics).

    * ``binary``: accuracy/precision/recall/specificity/iou are the stats of
      the positive class (1).
    * ``multiclass``: macro averages over classes; accuracy is the macro
      per-class recall.
    * ``multilabel``: as multiclass, but per-label accuracy is
      (tp_c+tn_c)/total, macro-averaged.

    ``dice`` (macro over classes) and ``mean_iou`` (macro Jaccard) do not
    depend on the task.
    """
    if task not in ("binary", "multiclass", "multilabel"):
        raise ValueError(f"unknown task {task!r}")
    cm = cm.to(torch.float64)
    total = cm.sum()
    tp_c = torch.diagonal(cm)
    fp_c = cm.sum(dim=0) - tp_c
    fn_c = cm.sum(dim=1) - tp_c
    tn_c = total - tp_c - fp_c - fn_c

    def safe(n, d):
        return torch.where(d > 0, n / torch.clamp(d, min=1e-12), torch.zeros_like(n))

    dice_c = safe(2 * tp_c, 2 * tp_c + fp_c + fn_c)
    iou_c = safe(tp_c, tp_c + fp_c + fn_c)
    if task == "binary":
        tp, fp, fn = tp_c[1], fp_c[1], fn_c[1]
        tn = total - tp - fp - fn
        return {
            "accuracy": safe(tp + tn, total),
            "precision": safe(tp, tp + fp),
            "recall": safe(tp, tp + fn),
            "specificity": safe(tn, tn + fp),
            "dice": dice_c.mean(),
            "iou": safe(tp, tp + fp + fn),
            "mean_iou": iou_c.mean(),
        }
    recall_c = safe(tp_c, tp_c + fn_c)
    if task == "multiclass":
        accuracy = recall_c.mean()
    else:
        accuracy = safe(tp_c + tn_c, total).mean()
    return {
        "accuracy": accuracy,
        "precision": safe(tp_c, tp_c + fp_c).mean(),
        "recall": recall_c.mean(),
        "specificity": safe(tn_c, tn_c + fp_c).mean(),
        "dice": dice_c.mean(),
        "iou": iou_c.mean(),
        "mean_iou": iou_c.mean(),
    }


class ConfusionAccumulator:
    """The epoch state: ``cm = ConfusionAccumulator.init(C, device)``, then
    ``cm += confusion_matrix(pred, target, C)`` per batch, then
    ``derived_metrics(cm)``."""

    @staticmethod
    def init(num_classes: int, device: torch.device | str | None = None) -> torch.Tensor:
        return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
