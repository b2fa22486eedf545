"""The port's twelve losses (``lmnet_tpu_torch/losses``) against JAX's
(``lmnet_tpu/losses``) on seeded numpy inputs, float32 on both sides: the
values within rtol 1e-5 / atol 1e-6, the gradients with respect to the
logits (or probabilities) within rtol 1e-4 / atol 1e-6 x their largest.
A loss that returns a vector is reduced against the same fixed random
weights on both sides before its gradient is taken."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lmnet_tpu.losses as J
import lmnet_tpu_torch.losses as T


def _check(j_fn, t_fn, inputs, diff=0):
    """Hold ``t_fn(*inputs)`` against ``j_fn(*inputs)`` and the gradients of
    both with respect to input ``diff``."""
    j_in = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in inputs]
    t_in = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a for a in inputs]
    t_in[diff] = t_in[diff].requires_grad_()
    want = np.asarray(j_fn(*j_in))
    got = t_fn(*t_in)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    w = np.random.RandomState(9).uniform(0.5, 1.5, want.shape).astype(np.float32)

    def j_scalar(x):
        args = list(j_in)
        args[diff] = x
        return jnp.sum(j_fn(*args) * w)

    j_grad = np.asarray(jax.grad(j_scalar)(j_in[diff]))
    (got * torch.from_numpy(w)).sum().backward()
    t_grad = t_in[diff].grad.numpy()
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-4, atol=1e-6 * np.abs(j_grad).max())


def _logits(rng, shape, scale=3.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("weight,smoothing,C", [
    (None, 0.0, 2), (None, 0.1, 3), ((1.0, 4.0), 0.001, 2), ((0.5, 1.0, 2.0), 0.0, 3),
])
def test_cross_entropy_loss(weight, smoothing, C):
    rng = np.random.RandomState(1)
    logits, labels = _logits(rng, (2, 6, 7, C)), rng.randint(0, C, (2, 6, 7))
    _check(lambda x, y: J.cross_entropy_loss(x, y, weight, smoothing),
           lambda x, y: T.cross_entropy_loss(x, y, weight, smoothing), [logits, labels])


@pytest.mark.parametrize("weight,softmax,ignore", [
    (None, True, False), ((1.0, 4.0), True, False), ((1.0, 4.0), True, True),
    ((1.0, 2.0), False, False),
])
def test_dice_loss(weight, softmax, ignore):
    rng = np.random.RandomState(2)
    logits, labels = _logits(rng, (2, 6, 7, 2)), rng.randint(0, 2, (2, 6, 7))
    if not softmax:
        logits = rng.uniform(0, 1, logits.shape).astype(np.float32)
    mask = (rng.uniform(size=(2, 6, 7)) < 0.3).astype(np.int32) if ignore else None
    _check(lambda x, y: J.dice_loss(x, y, weight, softmax, None if mask is None else
                                    jnp.asarray(mask)),
           lambda x, y: T.dice_loss(x, y, weight, softmax, None if mask is None else
                                    torch.from_numpy(mask)), [logits, labels])


def test_segmentation_loss():
    rng = np.random.RandomState(3)
    logits, labels = _logits(rng, (2, 8, 8, 2)), rng.randint(0, 2, (2, 8, 8))
    _check(J.segmentation_loss, T.segmentation_loss, [logits, labels])


@pytest.mark.parametrize("C", [2, 4])
def test_bce_dice_loss(C):
    rng = np.random.RandomState(4)
    logits, labels = _logits(rng, (3, 5, 6, C)), rng.randint(0, C, (3, 5, 6))
    _check(J.bce_dice_loss, T.bce_dice_loss, [logits, labels])


@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_focal_loss(gamma):
    rng = np.random.RandomState(5)
    logits = _logits(rng, (8, 3), 2.0)
    labels = (rng.uniform(size=(8, 3)) < 0.4).astype(np.float32)
    alpha = rng.uniform(0.2, 1.0, (8, 1)).astype(np.float32)
    _check(lambda x, y, a: J.focal_loss(x, y, a, gamma),
           lambda x, y, a: T.focal_loss(x, y, a, gamma), [logits, labels, alpha])


@pytest.mark.parametrize("alpha,gamma,reduction", [
    (0.25, 2.0, "mean"), (0.25, 2.0, "sum"), (0.25, 2.0, "none"), (-1.0, 1.5, "mean"),
])
def test_sigmoid_focal_loss(alpha, gamma, reduction):
    rng = np.random.RandomState(6)
    logits = _logits(rng, (2, 5, 6), 2.0)
    targets = (rng.uniform(size=(2, 5, 6)) < 0.5).astype(np.float32)
    _check(lambda x, t: J.sigmoid_focal_loss(x, t, alpha, gamma, reduction),
           lambda x, t: T.sigmoid_focal_loss(x, t, alpha, gamma, reduction), [logits, targets])


@pytest.mark.parametrize("C", [2, 3])
def test_focal_loss_per_class(C):
    rng = np.random.RandomState(7)
    logits, labels = _logits(rng, (2, 5, 6, C), 2.0), rng.randint(0, C, (2, 5, 6))
    _check(J.focal_loss_per_class, T.focal_loss_per_class, [logits, labels])


@pytest.mark.parametrize("spc,beta", [((10, 200, 3000), 0.9999), ((50, 50), 0.99),
                                      ((1, 7, 0, 4), 0.9)])
def test_effective_number_weights(spc, beta):
    """float64 numpy arithmetic on both sides, the float32 result equal."""
    np.testing.assert_array_equal(T.effective_number_weights(spc, beta).numpy(),
                                  np.asarray(J.effective_number_weights(spc, beta)))
    assert T.effective_number_weights(spc, beta).dtype == torch.float32


@pytest.mark.parametrize("loss_type", ["focal", "sigmoid", "softmax"])
def test_class_balanced_loss(loss_type):
    rng = np.random.RandomState(8)
    logits, labels = _logits(rng, (12, 3), 2.0), rng.randint(0, 3, (12,))
    spc = (30, 400, 5)
    _check(lambda x, y: J.class_balanced_loss(x, y, spc, 0.999, 2.0, loss_type),
           lambda x, y: T.class_balanced_loss(x, y, spc, 0.999, 2.0, loss_type), [logits, labels])


@pytest.mark.parametrize("smooth,exponent", [(1.0, 2.0), (0.5, 1.0)])
def test_mmseg_binary_dice_loss(smooth, exponent):
    rng = np.random.RandomState(10)
    pred = rng.uniform(0, 1, (3, 5, 6)).astype(np.float32)
    target = (rng.uniform(size=(3, 5, 6)) < 0.4).astype(np.float32)
    valid = (rng.uniform(size=(3, 5, 6)) < 0.8).astype(np.int32)
    _check(lambda p, t, m: J.mmseg_binary_dice_loss(p, t, m, smooth, exponent),
           lambda p, t, m: T.mmseg_binary_dice_loss(p, t, m, smooth, exponent),
           [pred, target, valid])


@pytest.mark.parametrize("class_weight,ignore_index", [(None, 255), ((1.0, 3.0, 0.5), 255),
                                                       ((1.0, 3.0, 0.5), 1)])
def test_mmseg_dice_loss(class_weight, ignore_index):
    rng = np.random.RandomState(11)
    probs = rng.uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    target = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 5, 6))]
    valid = (rng.uniform(size=(2, 5, 6)) < 0.8).astype(np.int32)
    _check(lambda p, t, m: J.mmseg_dice_loss(p, t, m, 1.0, 2.0, class_weight, ignore_index),
           lambda p, t, m: T.mmseg_dice_loss(p, t, m, 1.0, 2.0, class_weight, ignore_index),
           [probs, target, valid])


@pytest.mark.parametrize("class_weight,loss_weight,ignore_index", [
    (None, 1.0, 255), ((1.0, 4.0), 0.5, 255), (None, 1.0, 1),
])
def test_official_dice_loss(class_weight, loss_weight, ignore_index):
    """Labels include the ignore value 255 (masked, its one-hot clamped)."""
    rng = np.random.RandomState(12)
    logits = _logits(rng, (2, 6, 5, 2))
    labels = rng.randint(0, 2, (2, 6, 5))
    labels[rng.uniform(size=labels.shape) < 0.2] = 255
    _check(lambda x, y: J.official_dice_loss(x, y, 1.0, 2.0, class_weight, loss_weight,
                                             ignore_index),
           lambda x, y: T.official_dice_loss(x, y, 1.0, 2.0, class_weight, loss_weight,
                                             ignore_index), [logits, labels])


def test_every_jax_loss_is_ported():
    assert sorted(T.__all__) == sorted(J.__all__)
