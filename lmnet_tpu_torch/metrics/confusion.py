"""Confusion-matrix metrics, accumulated on the device, and the
reference's host-side metric helpers.

Counterpart of ``lmnet_tpu/metrics/confusion.py``. ``confusion_matrix``,
``derived_metrics`` and ``ConfusionAccumulator``: the per-epoch state is
one (C, C) matrix on the device; the host reads it once at the end. Counts
are int64, so they stay exact at any dataset size. ``binary_iou`` and
``binary_dice`` (the reference's ``iou_pytorch``/``dice_pytorch``) are
torch. The numpy helpers (``relative_volume_difference``,
``MetricTracker``, ``per_class_confusion``, ``multi_class_confusion``,
``binary_eval``, ``multi_eval``, ``Evaluator``; reference
``utils/metrics.py``) are copies of JAX's, which cannot be imported:
``lmnet_tpu/metrics/__init__.py`` imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix; rows = target class, cols = predicted.

    A scatter-add into C*C bins: ``torch.bincount`` on a CUDA tensor reads
    the largest index back to the host, a sync at every step."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=idx.device)
    return cm.scatter_add_(0, idx, torch.ones_like(idx)).reshape(num_classes, num_classes)


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


def relative_volume_difference(pred: np.ndarray, target: np.ndarray) -> float:
    """RVD = (|pred| - |target|) / |target| for the foreground class
    (reference ``utils/metrics.py:14-25`` ``ravd`` /
    ``train_eval_utils.py:27-52`` RVDEvaluator semantics)."""
    vol_p = float(np.count_nonzero(pred))
    vol_t = float(np.count_nonzero(target))
    if vol_t == 0:
        return float("nan")
    return (vol_p - vol_t) / vol_t


class MetricTracker:
    """Running average meter (reference ``utils/metrics.py:90-106``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def per_class_confusion(
    truth: np.ndarray, pred: np.ndarray, c: int = 1, dtype=np.float64
):
    """Per-image tp/tn/fp/fn counts for class ``c`` on (B, H, W) label maps
    (reference ``utils/metrics.py:25-40`` ``ConfusionMatrix``). Returns four
    (B,) arrays."""
    gt = np.equal(truth, c)
    pd = np.equal(pred, c)
    tp = np.logical_and(pd, gt).sum((1, 2)).astype(dtype)
    tn = np.logical_and(~pd, ~gt).sum((1, 2)).astype(dtype)
    fp = np.logical_and(pd, ~gt).sum((1, 2)).astype(dtype)
    fn = np.logical_and(~pd, gt).sum((1, 2)).astype(dtype)
    return tp, tn, fp, fn


def multi_class_confusion(
    truth: np.ndarray, pred: np.ndarray, n_classes: int = 2
):
    """(B, C) tp/tn/fp/fn stacks over all classes (reference
    ``utils/metrics.py:5-10`` ``get_multi_ConfusionMatrix``)."""
    batch = truth.shape[0]
    tp = np.zeros((batch, n_classes))
    tn = np.zeros((batch, n_classes))
    fp = np.zeros((batch, n_classes))
    fn = np.zeros((batch, n_classes))
    for c in range(n_classes):
        tp[:, c], tn[:, c], fp[:, c], fn[:, c] = per_class_confusion(
            truth, pred, c=c
        )
    return tp, tn, fp, fn


def binary_eval(truth: np.ndarray, pred: np.ndarray):
    """Batch-summed (acc, prec, recall, dice, iou) for the foreground class
    (reference ``utils/metrics.py:79-86``). Per the reference's ``my_*``
    helpers (:42-78), any 0/0 ratio resolves to 1 before summing."""
    tp, tn, fp, fn = per_class_confusion(truth, pred, c=1)

    def safe_one(num, den):
        return np.divide(num, den, out=np.ones_like(num), where=den != 0.0)

    acc = ((tp + tn) / (tp + tn + fp + fn)).sum()
    prec = safe_one(tp, tp + fp).sum()
    recall = safe_one(tp, tp + fn).sum()
    dice = safe_one(2 * tp, 2 * tp + fp + fn).sum()
    iou = safe_one(tp, tp + fp + fn).sum()
    return acc, prec, recall, dice, iou


def multi_eval(truth: np.ndarray, pred: np.ndarray, n_classes: int = 2):
    """Batch-summed class-nanmean (acc, prec, recall, dice, iou) (reference
    ``utils/metrics.py:11-24``): 0/0 classes are nan and drop out of the
    per-image class mean."""
    tp, tn, fp, fn = multi_class_confusion(truth, pred, n_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = (tp + tn) / (tp + tn + fp + fn)
        prec = tp / (tp + fp)
        recall = tp / (tp + fn)
        dice = 2 * tp / (2 * tp + fp + fn)
        iou = tp / (tp + fp + fn)
    return tuple(
        float(np.nanmean(m, 1).sum()) for m in (acc, prec, recall, dice, iou)
    )


def binary_iou(predictions: torch.Tensor, labels: torch.Tensor, e: float = 1e-7) -> torch.Tensor:
    """Per-image smoothed binary IoU on probability or score maps (reference
    ``utils/metrics.py:139-148`` ``iou_pytorch``): scores > 0.5, labels
    != 0, IoU = (|p & t| + e) / (|p | t| + e). (B, H, W) -> (B,) float32."""
    p = (predictions > 0.5).to(torch.float32)
    t = (labels != 0).to(torch.float32)
    inter = (p * t).sum(dim=(1, 2))
    union = torch.maximum(p, t).sum(dim=(1, 2))
    return (inter + e) / (union + e)


def binary_dice(predictions: torch.Tensor, labels: torch.Tensor, e: float = 1e-7) -> torch.Tensor:
    """Per-image smoothed binary Dice (reference ``utils/metrics.py:151-159``
    ``dice_pytorch``). (B, H, W) -> (B,) float32."""
    p = (predictions > 0.5).to(torch.float32)
    t = (labels != 0).to(torch.float32)
    inter = (p * t).sum(dim=(1, 2))
    return (2.0 * inter + e) / (p.sum(dim=(1, 2)) + t.sum(dim=(1, 2)) + e)


# reference-name aliases for drop-in compatibility
ConfusionMatrix = per_class_confusion
get_multi_ConfusionMatrix = multi_class_confusion
iou_pytorch = binary_iou
dice_pytorch = binary_dice


class Evaluator:
    """Numpy confusion-matrix evaluator, API-parity with the reference's
    latent engine (utils/metrics.py:162-222): add_batch + Accuracy /
    Mean_Accuracy / Recall / Mean_Recall / Precision / Specificity / Dice /
    Mean_Dice / MIoU / FWIoU."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)

    def _generate_matrix(self, gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
        mask = (gt >= 0) & (gt < self.num_class)
        label = self.num_class * gt[mask].astype(int) + pred[mask].astype(int)
        count = np.bincount(label, minlength=self.num_class**2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray) -> None:
        assert gt_image.shape == pre_image.shape
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros_like(self.confusion_matrix)

    # ---- derived metrics -------------------------------------------------
    @property
    def _counts(self):
        cm = self.confusion_matrix
        tp = np.diag(cm)
        fp = cm.sum(axis=0) - tp
        fn = cm.sum(axis=1) - tp
        tn = cm.sum() - tp - fp - fn
        return tp, fp, fn, tn

    def Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / cm.sum())

    def Mean_Accuracy(self) -> float:
        """nanmean of per-class diag / GRAND total — the reference divides by
        ``confusion_matrix.sum()`` (utils/metrics.py:169-172), not row sums;
        reproduced as-is for parity."""
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum()
        return float(np.nanmean(acc))

    def Recall(self) -> float:  # foreground class
        tp, fp, fn, tn = self._counts
        return float(tp[1] / max(tp[1] + fn[1], 1e-12))

    def Mean_Recall(self) -> float:
        """nanmean of per-class recall (reference utils/metrics.py:175-178)."""
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            recall = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(recall))

    def Precision(self) -> float:
        tp, fp, fn, tn = self._counts
        return float(tp[1] / max(tp[1] + fp[1], 1e-12))

    def Specificity(self) -> float:
        tp, fp, fn, tn = self._counts
        return float(tn[1] / max(tn[1] + fp[1], 1e-12))

    def Dice(self) -> float:
        tp, fp, fn, tn = self._counts
        return float(2 * tp[1] / max(2 * tp[1] + fp[1] + fn[1], 1e-12))

    def Mean_Dice(self) -> float:
        tp, fp, fn, tn = self._counts
        denom = np.maximum(2 * tp + fp + fn, 1e-12)
        return float(np.mean(2 * tp / denom))

    def MIoU(self) -> float:
        tp, fp, fn, tn = self._counts
        denom = np.maximum(tp + fp + fn, 1e-12)
        return float(np.mean(tp / denom))

    def FWIoU(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / cm.sum()
        tp, fp, fn, tn = self._counts
        iu = tp / np.maximum(tp + fp + fn, 1e-12)
        return float((freq[freq > 0] * iu[freq > 0]).sum())
