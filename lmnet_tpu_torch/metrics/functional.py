"""smp-style segmentation metric suite: tp/fp/fn/tn stats + reductions.

Semantics parity with the reference's vendored segmentation_models_pytorch
module (reference ``utils/functional.py``):
  * ``get_stats`` (:61-219): per-image, per-class tp/fp/fn/tn for 'binary',
    'multiclass' (argmax + optional ignore_index) and 'multilabel'
    (threshold) modes — returns (N, C) arrays.
  * ``compute_metric`` (:237-296): reductions 'micro', 'macro', 'weighted',
    'micro-imagewise', 'macro-imagewise', 'weighted-imagewise', None.
  * the 15 metric wrappers (:302-692): fbeta, f1, iou, accuracy,
    sensitivity, specificity, balanced_accuracy, ppv, npv, fnr, fpr, fdr,
    false_omission_rate, positive/negative likelihood ratio.

Implemented in pure numpy (host-side epoch analysis tool); the hot path uses
``lmnet_tpu_torch.metrics.confusion`` on device instead. A copy of
``lmnet_tpu/metrics/functional.py``, which cannot be imported:
``lmnet_tpu/metrics/__init__.py`` imports jax.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "get_stats",
    "compute_metric",
    "fbeta_score",
    "f1_score",
    "iou_score",
    "accuracy",
    "sensitivity",
    "specificity",
    "recall",
    "precision",
    "balanced_accuracy",
    "positive_predictive_value",
    "negative_predictive_value",
    "false_negative_rate",
    "false_positive_rate",
    "false_discovery_rate",
    "false_omission_rate",
    "positive_likelihood_ratio",
    "negative_likelihood_ratio",
]


def get_stats(
    output: np.ndarray,
    target: np.ndarray,
    mode: str,
    ignore_index: int | None = None,
    threshold: float | None = None,
    num_classes: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-image per-class (tp, fp, fn, tn) counts, each of shape (N, C)."""
    output = np.asarray(output)
    target = np.asarray(target)

    if mode == "multiclass":
        if threshold is not None:
            raise ValueError("threshold is not supported for multiclass mode")
        if num_classes is None:
            raise ValueError("num_classes is required for multiclass mode")
        return _stats_multiclass(output, target, num_classes, ignore_index)

    if threshold is not None:
        output = (output > threshold).astype(np.int64)
        target = (target > threshold).astype(np.int64)
    output = output.astype(np.int64)
    target = target.astype(np.int64)
    if mode == "binary":
        if output.ndim == target.ndim and output.ndim >= 2 and output.shape[1] != 1:
            # (N, H, W) style: add a class dim
            if output.ndim == 3:
                output = output[:, None]
                target = target[:, None]
    n = output.shape[0]
    c = output.shape[1] if output.ndim > 1 else 1
    output = output.reshape(n, c, -1)
    target = target.reshape(n, c, -1)
    tp = np.sum(output * target, axis=2)
    fp = np.sum(output, axis=2) - tp
    fn = np.sum(target, axis=2) - tp
    tn = output.shape[2] - tp - fp - fn
    return tp, fp, fn, tn


def _stats_multiclass(output, target, num_classes, ignore_index):
    n = output.shape[0]
    output = output.reshape(n, -1).astype(np.int64)
    target = target.reshape(n, -1).astype(np.int64)
    if ignore_index is not None:
        keep = target != ignore_index
    else:
        keep = np.ones_like(target, dtype=bool)
    tp = np.zeros((n, num_classes), dtype=np.int64)
    fp = np.zeros((n, num_classes), dtype=np.int64)
    fn = np.zeros((n, num_classes), dtype=np.int64)
    tn = np.zeros((n, num_classes), dtype=np.int64)
    for i in range(n):
        o, t = output[i][keep[i]], target[i][keep[i]]
        total = o.size
        for c in range(num_classes):
            tp_i = int(np.sum((o == c) & (t == c)))
            fp_i = int(np.sum((o == c) & (t != c)))
            fn_i = int(np.sum((o != c) & (t == c)))
            tp[i, c], fp[i, c], fn[i, c] = tp_i, fp_i, fn_i
            tn[i, c] = total - tp_i - fp_i - fn_i
    return tp, fp, fn, tn


def _handle_zero_division(x, zero_division):
    nans = np.isnan(x)
    if np.any(nans):
        value = 0.0 if zero_division in ("warn", 0, 0.0) else float(zero_division)
        x = np.where(nans, value, x)
    return x


def compute_metric(
    metric_fn,
    tp,
    fp,
    fn,
    tn,
    reduction: str | None = None,
    class_weights=None,
    zero_division="warn",
    **metric_kwargs,
):
    """Apply ``metric_fn(tp, fp, fn, tn)`` under an smp reduction
    (reference utils/functional.py:237-296)."""
    tp, fp, fn, tn = (np.asarray(x, dtype=np.float64) for x in (tp, fp, fn, tn))
    if class_weights is None and reduction is not None and "weighted" in reduction:
        raise ValueError("class_weights required for 'weighted' reductions")
    cw = np.asarray(class_weights if class_weights is not None else 1.0, dtype=np.float64)
    cw = cw / cw.sum() if cw.ndim else cw

    with np.errstate(divide="ignore", invalid="ignore"):
        if reduction == "micro":
            score = metric_fn(tp.sum(), fp.sum(), fn.sum(), tn.sum(), **metric_kwargs)
            return float(_handle_zero_division(np.asarray(score), zero_division))
        if reduction == "macro":
            score = metric_fn(tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0), **metric_kwargs)
            score = _handle_zero_division(score, zero_division)
            return float((score * (cw * np.ones_like(score) if cw.ndim == 0 else cw)).mean()
                         if cw.ndim == 0 else (score * cw).sum())
        if reduction == "weighted":
            score = metric_fn(tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0), **metric_kwargs)
            score = _handle_zero_division(score, zero_division)
            return float((score * cw).sum())
        if reduction == "micro-imagewise":
            score = metric_fn(tp.sum(1), fp.sum(1), fn.sum(1), tn.sum(1), **metric_kwargs)
            score = _handle_zero_division(score, zero_division)
            return float(score.mean())
        if reduction in ("macro-imagewise", "weighted-imagewise"):
            score = metric_fn(tp, fp, fn, tn, **metric_kwargs)
            score = _handle_zero_division(score, zero_division)
            score = (score * cw).mean(1) if reduction == "weighted-imagewise" else score.mean(1)
            return float(score.mean())
        if reduction in ("none", None):
            score = metric_fn(tp, fp, fn, tn, **metric_kwargs)
            return _handle_zero_division(score, zero_division)
    raise ValueError(f"unknown reduction {reduction!r}")


# ---------------------------------------------------------------------------
# metric formulas (reference utils/functional.py:302-692)
# ---------------------------------------------------------------------------


def _fbeta(tp, fp, fn, tn, beta=1.0):
    b2 = beta**2
    return ((1 + b2) * tp) / ((1 + b2) * tp + b2 * fn + fp)


def _iou(tp, fp, fn, tn):
    return tp / (tp + fp + fn)


def _accuracy(tp, fp, fn, tn):
    return (tp + tn) / (tp + fp + fn + tn)


def _sensitivity(tp, fp, fn, tn):
    return tp / (tp + fn)


def _specificity(tp, fp, fn, tn):
    return tn / (tn + fp)


def _balanced_accuracy(tp, fp, fn, tn):
    return (_sensitivity(tp, fp, fn, tn) + _specificity(tp, fp, fn, tn)) / 2


def _ppv(tp, fp, fn, tn):
    return tp / (tp + fp)


def _npv(tp, fp, fn, tn):
    return tn / (tn + fn)


def _fnr(tp, fp, fn, tn):
    return fn / (fn + tp)


def _fpr(tp, fp, fn, tn):
    return fp / (fp + tn)


def _fdr(tp, fp, fn, tn):
    return 1 - _ppv(tp, fp, fn, tn)


def _for(tp, fp, fn, tn):
    return 1 - _npv(tp, fp, fn, tn)


def _lr_pos(tp, fp, fn, tn):
    return _sensitivity(tp, fp, fn, tn) / _fpr(tp, fp, fn, tn)


def _lr_neg(tp, fp, fn, tn):
    return _fnr(tp, fp, fn, tn) / _specificity(tp, fp, fn, tn)


def _make(metric_fn, **fixed):
    def wrapper(tp, fp, fn, tn, reduction=None, class_weights=None,
                zero_division="warn", **kw):
        return compute_metric(
            metric_fn, tp, fp, fn, tn, reduction=reduction,
            class_weights=class_weights, zero_division=zero_division,
            **{**fixed, **kw},
        )
    return wrapper


fbeta_score = _make(_fbeta)
f1_score = _make(_fbeta, beta=1.0)
iou_score = _make(_iou)
accuracy = _make(_accuracy)
sensitivity = _make(_sensitivity)
specificity = _make(_specificity)
recall = sensitivity
precision = _make(_ppv)
balanced_accuracy = _make(_balanced_accuracy)
positive_predictive_value = _make(_ppv)
negative_predictive_value = _make(_npv)
false_negative_rate = _make(_fnr)
false_positive_rate = _make(_fpr)
false_discovery_rate = _make(_fdr)
false_omission_rate = _make(_for)
positive_likelihood_ratio = _make(_lr_pos)
negative_likelihood_ratio = _make(_lr_neg)
