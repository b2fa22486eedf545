"""Epoch-level train and eval loops.

Counterpart of ``lmnet_tpu/train/loop.py`` (``train_one_epoch``,
``evaluate``): metrics accumulate on the device and the host reads them once
per epoch. Not ported yet (``ROADMAP.md``): the on-device train augmentation
(``augment_on_device=True``, JAX's default), HD95, the device mesh and the
multi-host reduction. The dropout stream is the train state's generator,
so the loop takes no key.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lmnet_tpu_torch.data.augment import eval_pipeline
from lmnet_tpu_torch.metrics.confusion import ConfusionAccumulator, derived_metrics
from lmnet_tpu_torch.train.engine import TrainState, eval_step, train_step


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy batch on ``device``; to a card through pinned memory without
    waiting for the copy."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train_one_epoch(
    state: TrainState,
    loader,
    num_classes: int = 2,
    img_size: int = 256,
    augment_on_device: bool = True,
    log_every: int = 0,
    task: str = "binary",
):
    """Run one training epoch over the loader's (uint8 images, uint8 masks)
    numpy batches. Returns (state, total_loss, metrics) with
    ``metrics['images_per_sec']``.

    ``augment_on_device=False`` feeds the batches through ``eval_pipeline``
    (normalise only), as the JAX loop does; the train augmentation
    (``True``, JAX's default) is not ported yet and raises.
    """
    if augment_on_device:
        raise NotImplementedError(
            "the on-device train augmentation is not ported yet (ROADMAP slice 4: "
            "data pipeline and CLI); pass augment_on_device=False"
        )
    device = _device(state)
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    n_images = 0
    t0 = time.perf_counter()
    for bi, (images, masks) in enumerate(loader):
        x, y = eval_pipeline(_to_device(images, device), _to_device(masks, device), img_size)
        state, loss, cm = train_step(state, x, y, cm, num_classes=num_classes)
        total += loss
        n_images += images.shape[0]
        if log_every and (bi + 1) % log_every == 0:
            print(f"  step {bi + 1}: loss={float(loss):.4f}")
    total_loss = float(total)  # the epoch's one host sync
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    metrics["images_per_sec"] = n_images / max(seconds, 1e-9) if n_images else 0.0
    return state, total_loss, metrics


def evaluate(
    state: TrainState,
    loader,
    num_classes: int = 2,
    img_size: int = 256,
    compute_hd95: bool = False,
    task: str = "binary",
):
    """Evaluate over the loader's numpy batches with the model's eval
    forward. Returns (total CE loss, metrics). HD95 is not ported yet:
    ``compute_hd95=True`` raises."""
    if compute_hd95:
        raise NotImplementedError(
            "HD95 is not ported yet (ROADMAP A3/A4); pass compute_hd95=False"
        )
    device = _device(state)
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for images, masks in loader:
        x, y = eval_pipeline(_to_device(images, device), _to_device(masks, device), img_size)
        loss, cm, _ = eval_step(state, x, y, cm, num_classes=num_classes)
        total += loss
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    return float(total), metrics
