"""The port's metrics (``lmnet_tpu_torch/metrics``) against JAX's
(``lmnet_tpu/metrics``): the numpy copies (``confusion.py``'s host
helpers, ``functional.py``) give exactly JAX's numbers, ``binary_iou`` and
``binary_dice`` (torch there, jnp here) agree within rtol 1e-6, the 0/0
cases resolve as JAX resolves them, and the reference-name aliases are the
same objects as the functions they name."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lmnet_tpu.metrics as J
import lmnet_tpu.metrics.functional as JF
import lmnet_tpu_torch.metrics as T
import lmnet_tpu_torch.metrics.functional as TF


def _maps(seed, shape=(3, 9, 10), classes=2, empty=False):
    rng = np.random.RandomState(seed)
    truth = rng.randint(0, classes, shape)
    pred = np.where(rng.uniform(size=shape) < 0.7, truth, rng.randint(0, classes, shape))
    if empty:  # image 0 has no foreground in either map: 0/0 everywhere
        truth[0] = 0
        pred[0] = 0
    return truth, pred


def _same(a, b):
    """Equal, nan where the other is nan, as numbers or tuples of them."""
    np.testing.assert_array_equal(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


@pytest.mark.parametrize("empty", [False, True])
def test_binary_eval_and_per_class_confusion(empty):
    """binary_eval resolves each 0/0 ratio to 1 before summing."""
    truth, pred = _maps(1, empty=empty)
    _same(T.binary_eval(truth, pred), J.binary_eval(truth, pred))
    for c in (0, 1):
        _same(T.per_class_confusion(truth, pred, c), J.per_class_confusion(truth, pred, c))
    if empty:
        assert T.binary_eval(truth[:1], pred[:1])[1:] == (1.0, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("classes,empty", [(2, False), (3, False), (3, True)])
def test_multi_eval_and_multi_class_confusion(classes, empty):
    """multi_eval drops a 0/0 class as nan from the per-image class mean."""
    truth, pred = _maps(2, classes=classes, empty=empty)
    _same(T.multi_eval(truth, pred, classes), J.multi_eval(truth, pred, classes))
    _same(T.multi_class_confusion(truth, pred, classes),
          J.multi_class_confusion(truth, pred, classes))


@pytest.mark.parametrize("fg_pred,fg_truth", [(10, 8), (0, 5), (3, 0)])
def test_relative_volume_difference(fg_pred, fg_truth):
    pred, truth = np.zeros(20), np.zeros(20)
    pred[:fg_pred], truth[:fg_truth] = 1, 1
    _same(T.relative_volume_difference(pred, truth), J.relative_volume_difference(pred, truth))


def test_metric_tracker():
    t, j = T.MetricTracker(), J.MetricTracker()
    for v, n in ((0.5, 2), (1.25, 3), (0.0, 1)):
        t.update(v, n)
        j.update(v, n)
    assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count, j.avg)
    t.reset()
    assert (t.val, t.avg, t.sum, t.count) == (0.0, 0.0, 0.0, 0)


@pytest.mark.parametrize("classes,absent", [(2, False), (4, False), (4, True)])
def test_evaluator(classes, absent):
    """Every derived metric, with a class absent from both maps (its 0/0
    recall is nan and drops out of Mean_Recall); Mean_Accuracy divides by
    the grand total, as the reference does."""
    truth, pred = _maps(3, classes=classes)
    if absent:
        truth[truth == classes - 1] = 0
        pred[pred == classes - 1] = 0
    t, j = T.Evaluator(classes), J.Evaluator(classes)
    for k in range(2):
        t.add_batch(truth[k:k + 2], pred[k:k + 2])
        j.add_batch(truth[k:k + 2], pred[k:k + 2])
    np.testing.assert_array_equal(t.confusion_matrix, j.confusion_matrix)
    for name in ("Accuracy", "Mean_Accuracy", "Recall", "Mean_Recall", "Precision",
                 "Specificity", "Dice", "Mean_Dice", "MIoU", "FWIoU"):
        _same(getattr(t, name)(), getattr(j, name)())
    cm = t.confusion_matrix
    assert t.Mean_Accuracy() == pytest.approx(np.nanmean(np.diag(cm) / cm.sum()))
    t.reset()
    assert t.confusion_matrix.sum() == 0


@pytest.mark.parametrize("empty", [False, True])
def test_binary_iou_and_dice(empty):
    """Scores > 0.5 against labels != 0, per image, within rtol 1e-6; an
    image empty in both maps gives (0 + e) / (0 + e) = 1."""
    rng = np.random.RandomState(4)
    scores = rng.uniform(0, 1, (3, 8, 9)).astype(np.float32)
    labels = rng.randint(0, 3, (3, 8, 9))
    if empty:
        scores[0] = 0.2
        labels[0] = 0
    for t_fn, j_fn in ((T.binary_iou, J.binary_iou), (T.binary_dice, J.binary_dice)):
        got = t_fn(torch.from_numpy(scores), torch.from_numpy(labels)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_fn(jnp.asarray(scores), jnp.asarray(labels))),
                                   rtol=1e-6)
        if empty:
            assert got[0] == pytest.approx(1.0)


def test_aliases_are_the_functions():
    assert T.ConfusionMatrix is T.per_class_confusion
    assert T.get_multi_ConfusionMatrix is T.multi_class_confusion
    assert T.iou_pytorch is T.binary_iou
    assert T.dice_pytorch is T.binary_dice
    assert T.functional.recall is T.functional.sensitivity


@pytest.mark.parametrize("mode,kw", [
    ("binary", {}), ("binary", {"threshold": 0.5}), ("multilabel", {"threshold": 0.4}),
    ("multiclass", {"num_classes": 3}), ("multiclass", {"num_classes": 3, "ignore_index": 2}),
])
def test_get_stats(mode, kw):
    rng = np.random.RandomState(5)
    if mode == "multiclass":
        out, tgt = rng.randint(0, 3, (4, 6, 7)), rng.randint(0, 3, (4, 6, 7))
    elif "threshold" in kw:
        shape = (4, 3, 6, 7) if mode == "multilabel" else (4, 1, 6, 7)
        out, tgt = rng.uniform(size=shape), (rng.uniform(size=shape) < 0.5).astype(np.float32)
    else:
        out, tgt = rng.randint(0, 2, (4, 6, 7)), rng.randint(0, 2, (4, 6, 7))
    for a, b in zip(TF.get_stats(out, tgt, mode, **kw), JF.get_stats(out, tgt, mode, **kw)):
        np.testing.assert_array_equal(a, b)


METRICS = ("fbeta_score", "f1_score", "iou_score", "accuracy", "sensitivity", "specificity",
           "recall", "precision", "balanced_accuracy", "positive_predictive_value",
           "negative_predictive_value", "false_negative_rate", "false_positive_rate",
           "false_discovery_rate", "false_omission_rate", "positive_likelihood_ratio",
           "negative_likelihood_ratio")
REDUCTIONS = ("micro", "macro", "weighted", "micro-imagewise", "macro-imagewise",
              "weighted-imagewise", "none", None)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_compute_metric_every_reduction(reduction):
    """Each of the 17 wrappers under each reduction, with a class that is
    0/0 in every image (zero_division resolves it), class weights for the
    weighted ones, and zero_division=1."""
    rng = np.random.RandomState(6)
    out, tgt = rng.randint(0, 3, (4, 5, 6)), rng.randint(0, 3, (4, 5, 6))
    out[out == 2], tgt[tgt == 2] = 0, 0
    stats = TF.get_stats(out, tgt, "multiclass", num_classes=3)
    kw = {"class_weights": [0.2, 0.3, 0.5]} if reduction and "weighted" in reduction else {}
    for name in METRICS:
        for zd in ("warn", 1):
            _same(getattr(TF, name)(*stats, reduction=reduction, zero_division=zd, **kw),
                  getattr(JF, name)(*stats, reduction=reduction, zero_division=zd, **kw))


def test_compute_metric_refusals():
    stats = TF.get_stats(np.ones((1, 2, 2)), np.ones((1, 2, 2)), "binary")
    with pytest.raises(ValueError, match="class_weights"):
        TF.iou_score(*stats, reduction="weighted")
    with pytest.raises(ValueError, match="unknown reduction"):
        TF.iou_score(*stats, reduction="median")
    with pytest.raises(ValueError):
        TF.get_stats(np.ones((1, 2)), np.ones((1, 2)), "multiclass", threshold=0.5)


def test_the_exports_are_jax_s():
    assert set(J.__all__) <= set(T.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
