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
run draws at epoch E.

``mesh`` (``parallel.make_mesh``): the data axis. Every rank reads the same
global batches and draws the same augmentation parameters for them, then
takes its own rows (``parallel/mesh.py::shard_rows``); the step's loss and
BatchNorm statistics are the global batch's (``train.engine.train_step``).
The training confusion matrix is summed over the ranks once an epoch; eval
sums the matrix, each batch's CE numerator and denominator and the HD95
sums in one float64 all-reduce, so a W-rank epoch reports what one process
reports. ``evaluate(cross_host=True)`` is JAX's multi-host eval: each rank
evaluates a loader of its own and (matrix, loss, HD95 sums) are summed over
the ranks (``_allreduce_eval``).

``spatial`` (JAX's): on a mesh with a 'spatial' axis of n > 1 ranks and an
``img_size`` that divides by 16 n (``parallel/mesh.py::shards_h``), each
rank also keeps its block of every image's rows, the steps run inside the
shard (halo exchanges, sums over the world), the matrices and eval sums
are summed over the world, and HD95 is taken on the gathered maps.
Otherwise every rank of the axis runs whole images, as JAX's fallback.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import torch.distributed as dist

from lmnet_tpu_torch.data.augment import apply_params, draw_params, eval_pipeline
from lmnet_tpu_torch.data.png import write_png
from lmnet_tpu_torch.metrics.confusion import (
    ConfusionAccumulator,
    confusion_matrix,
    derived_metrics,
)
from lmnet_tpu_torch.parallel.mesh import (
    data_group,
    eval_totals,
    h_rows,
    hd95_values,
    shard_context,
    shard_rows,
    shards_h,
    sum_float64,
    sum_group,
)
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
    mesh=None,
    spatial: bool = False,
):
    """Run one training epoch over the loader's (uint8 images, uint8 masks)
    numpy batches. Returns (state, total_loss, metrics) with
    ``metrics['images_per_sec']``.

    ``augment_on_device``: the train augmentation (``data/augment.py``) on
    the model's device, JAX's default; False feeds the batches through
    ``eval_pipeline`` (normalise only). ``seed`` and ``epoch`` seed the
    epoch's dropout and augmentation generators (``fold_seed``). ``mesh``:
    each batch split over the data axis (every rank needs a row of each);
    the loss, the metrics and the img/s are the global batch's. ``spatial``:
    the image H split over the mesh's 'spatial' axis where it divides.
    """
    device = _device(state)
    sharded = mesh is not None and shards_h(mesh, img_size, spatial)
    hs = h_rows(mesh, img_size) if sharded else slice(None)
    state.generator.manual_seed(fold_seed(seed, epoch, DROPOUT_STREAM))
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    n_images = 0
    t0 = time.perf_counter()
    for bi, (images, masks) in enumerate(loader):
        n = images.shape[0]
        rows = slice(0, n) if mesh is None else shard_rows(mesh, n)
        xi, mi = _to_device(images[rows], device), _to_device(masks[rows], device)
        if augment_on_device:  # the global batch's draws, this rank's rows of them
            params = draw_params(augment_generator(seed, epoch, bi), n,
                                 tuple(images.shape[1:3]), img_size)
            x, y = apply_params(xi, mi, {k: v[rows] for k, v in params.items()}, img_size)
        else:
            x, y = eval_pipeline(xi, mi, img_size)
        state, loss, cm = train_step(state, x[:, hs], y[:, hs], cm, num_classes=num_classes,
                                     mesh=mesh, global_rows=n, spatial=sharded)
        total += loss
        n_images += images.shape[0]
        if log_every and (bi + 1) % log_every == 0:
            print(f"  step {bi + 1}: loss={float(loss):.4f}")
    if mesh is not None:
        dist.all_reduce(cm, group=sum_group(mesh, sharded))
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
    mesh=None,
    cross_host: bool = False,
    spatial: bool = False,
):
    """Evaluate over the loader's numpy batches with the model's eval
    forward. Returns (total CE loss, metrics).

    ``compute_hd95``: also report the mean 95th-percentile Hausdorff
    distance of the class-1 masks over the images where both masks are
    non-empty (nan if none), on the host from ``eval_step``'s predictions:
    no second forward, one device read a batch.

    ``mesh``: each batch split over the data axis (a rank may hold none of
    a ragged tail's rows); the matrix, each batch's CE numerator and
    denominator and the HD95 sums are summed over the ranks in one float64
    all-reduce at the end (``eval_totals``), so the result is one
    process's. ``cross_host``: each rank's loader is its own shard,
    evaluated whole; JAX's ``_allreduce_eval`` sums (matrix, loss, HD95
    sums) over the ranks (the default group, or ``mesh``'s data axis).
    ``spatial``: with ``mesh`` (not ``cross_host``, which evaluates whole
    images as JAX's does), each rank evaluates its block of the image H
    where it divides, and the sums go over the world."""
    device = _device(state)
    cm = ConfusionAccumulator.init(num_classes, device)
    terms = []  # each batch's (CE numerator, denominator)
    hd_sum, hd_cnt = 0.0, 0
    split = mesh is not None and not cross_host
    sharded = split and shards_h(mesh, img_size, spatial)
    hs = h_rows(mesh, img_size) if sharded else slice(None)
    for images, masks in loader:
        rows = shard_rows(mesh, images.shape[0]) if split else slice(0, images.shape[0])
        if rows.start == rows.stop:  # a ragged tail left this rank no row
            terms.append(torch.zeros(2, device=device))
            continue
        x, y = eval_pipeline(_to_device(images[rows], device), _to_device(masks[rows], device),
                             img_size)
        x, y = x[:, hs], y[:, hs]
        with shard_context(mesh, sharded):
            nd, cm, preds = eval_step(state, x, y, cm, num_classes=num_classes)
            terms.append(nd)
            if compute_hd95:
                for v in hd95_values(preds, y):
                    hd_sum, hd_cnt = hd_sum + v, hd_cnt + 1
    group = data_group(mesh) if mesh is not None else None
    cm, total_loss, hd_sum, hd_cnt = eval_totals(cm, terms, hd_sum, hd_cnt,
                                                 sum_group(mesh, sharded) if split else None)
    cm, total_loss, hd_sum, hd_cnt = _allreduce_eval(cm, total_loss, hd_sum, hd_cnt,
                                                     cross_host, num_classes, group)
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    if compute_hd95:
        metrics["hd95"] = hd_sum / hd_cnt if hd_cnt else float("nan")
    return total_loss, metrics


def _allreduce_eval(cm, total_loss, hd_sum, hd_cnt, cross_host, num_classes, group=None):
    """JAX's ``_allreduce_eval``: the per-rank eval accumulators (matrix,
    loss, HD95 sum and count) summed over ``group`` (the default group when
    None) in one float64 all-reduce; a no-op without ``cross_host`` or for
    one rank. Every rank must call it."""
    if not cross_host or not dist.is_initialized() or dist.get_world_size(group) == 1:
        return cm, total_loss, hd_sum, hd_cnt
    group = dist.group.WORLD if group is None else group
    cm64, rest = sum_float64([cm, [total_loss, hd_sum, float(hd_cnt)]], group, cm.device)
    return (cm64.round().to(torch.int64).reshape(num_classes, num_classes), float(rest[0]),
            float(rest[1]), int(rest[2]))


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
