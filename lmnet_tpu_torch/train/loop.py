"""Epoch-level train and eval loops, and ``visualize``.

Counterpart of ``lmnet_tpu/train/loop.py`` (``train_one_epoch``,
``evaluate``, ``visualize``): metrics accumulate on the device and the host
reads them once per epoch; the train augmentation runs on the device.

JAX derives an epoch's randomness from ``fold_in(key(seed), epoch)``: one key
for the dropout masks, and ``fold_in(aug_key, bi)`` for batch ``bi``'s
augmentation. The port takes ``seed`` and ``epoch`` instead of a key and
derives torch generators the same way (``fold_seed``): the train state's
dropout generator is reseeded from (seed, epoch) at the start of the epoch,
and batch ``bi`` draws its augmentation from a CPU generator seeded from
(seed, epoch, bi). A run resumed at epoch E therefore draws what an unbroken
run draws at epoch E. Not ported: the device mesh and the multi-host
reduction (ROADMAP A8).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from lmnet_tpu_torch.data.augment import eval_pipeline, train_pipeline
from lmnet_tpu_torch.data.png import write_png
from lmnet_tpu_torch.metrics.confusion import ConfusionAccumulator, derived_metrics
from lmnet_tpu_torch.metrics.hd95 import hausdorff_distance_95
from lmnet_tpu_torch.train.engine import TrainState, eval_step, train_step

# the streams fold_seed derives from (seed, epoch)
DROPOUT_STREAM, AUGMENT_STREAM = 0, 1


def fold_seed(*ints: int) -> int:
    """A 63-bit generator seed derived from a tuple of integers, as JAX's
    ``fold_in`` derives a key: distinct tuples give unrelated streams."""
    entropy = [int(v) % 2**32 for v in ints]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def augment_generator(seed: int, epoch: int, batch_index: int) -> torch.Generator:
    """The CPU generator batch ``batch_index`` of ``epoch`` draws its
    augmentation parameters from."""
    return torch.Generator().manual_seed(fold_seed(seed, epoch, AUGMENT_STREAM, batch_index))


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
    seed: int = 0,
    epoch: int = 0,
):
    """Run one training epoch over the loader's (uint8 images, uint8 masks)
    numpy batches. Returns (state, total_loss, metrics) with
    ``metrics['images_per_sec']``.

    ``augment_on_device``: the train augmentation (``data/augment.py``) on
    the model's device, JAX's default; False feeds the batches through
    ``eval_pipeline`` (normalise only). ``seed`` and ``epoch`` seed the
    epoch's dropout and augmentation generators (``fold_seed``).
    """
    device = _device(state)
    state.generator.manual_seed(fold_seed(seed, epoch, DROPOUT_STREAM))
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    n_images = 0
    t0 = time.perf_counter()
    for bi, (images, masks) in enumerate(loader):
        xi, mi = _to_device(images, device), _to_device(masks, device)
        if augment_on_device:
            x, y = train_pipeline(augment_generator(seed, epoch, bi), xi, mi, out_size=img_size)
        else:
            x, y = eval_pipeline(xi, mi, img_size)
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
    forward. Returns (total CE loss, metrics).

    ``compute_hd95``: also report the mean 95th-percentile Hausdorff
    distance of the class-1 masks over the images where both masks are
    non-empty (nan if none), on the host from ``eval_step``'s predictions:
    no second forward, one device read a batch."""
    device = _device(state)
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    hd_sum, hd_cnt = 0.0, 0
    for images, masks in loader:
        x, y = eval_pipeline(_to_device(images, device), _to_device(masks, device), img_size)
        loss, cm, preds = eval_step(state, x, y, cm, num_classes=num_classes)
        total += loss
        if compute_hd95:
            for p, t in zip(preds.cpu().numpy(), y.cpu().numpy()):
                v = hausdorff_distance_95(p == 1, t == 1)
                if not np.isnan(v):
                    hd_sum += v
                    hd_cnt += 1
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    if compute_hd95:
        metrics["hd95"] = hd_sum / hd_cnt if hd_cnt else float("nan")
    return float(total), metrics


@torch.no_grad()
def visualize(
    state: TrainState,
    loader,
    out_dir: str,
    num_classes: int = 2,
    img_size: int = 256,
) -> int:
    """Render argmax predictions as colour overlays on the input images,
    one ``pred_{index:05d}.png`` per image (reference ``visualization``,
    train_eval_utils.py:207-221, with unique filenames). Returns the number
    written."""
    os.makedirs(out_dir, exist_ok=True)
    palette = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], dtype=np.uint8)
    device = _device(state)
    idx = 0
    for images, masks in loader:
        x, _ = eval_pipeline(_to_device(images, device), _to_device(masks, device), img_size)
        preds = state.model(x, train=False).argmax(dim=-1).cpu().numpy()
        for img, pred in zip(np.asarray(images), preds):
            overlay = palette[np.clip(pred, 0, len(palette) - 1)]
            write_png(os.path.join(out_dir, f"pred_{idx:05d}.png"),
                      (0.6 * img + 0.4 * overlay).astype(np.uint8))
            idx += 1
    return idx
