"""Train and eval steps and the optimisation state.

Counterpart of ``lmnet_tpu/train/engine.py``:
  * ``train_step``: train-mode forward, CE(weight, label smoothing) + Dice,
    backward (through the NAT backward kernel on a card), AdamW, the
    BatchNorm running-stat update (inside the forward) and the confusion
    matrix of the train logits;
  * AdamW(lr 1e-3, wd 1e-4) with a cosine schedule stepped per *epoch*, as
    a closed form of the global step;
  * the AMP analogue is the model's compute dtype (``LMNet(dtype=bf16)``),
    parameters float32.

The per-step path makes no host sync: the loss and the confusion matrix stay
on the device, and the learning rate comes from the host-side step count.

``train_step(mesh=...)`` is the data-parallel step, JAX's step on a batch
sharded over the mesh's 'data' axis: this rank's rows run the forward and
backward inside ``parallel/batch.py::global_batch`` (the loss and every
BatchNorm statistic over the global batch), then the gradients' mean over
the ranks (one all-reduce) goes into AdamW, which every rank runs alike.
With ``spatial=True`` the rows are also this rank's block of the image H
(the mesh's 'spatial' axis): the step runs inside ``parallel/batch.py::
shard`` too, its sums go over the world, and the gradients' mean over all
n_data x n_spatial ranks.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import torch
import torch.distributed as dist

from lmnet_tpu_torch.losses.losses import cross_entropy_loss, cross_entropy_terms, dice_loss
from lmnet_tpu_torch.metrics.confusion import confusion_matrix
from lmnet_tpu_torch.parallel.batch import all_reduce_grads, global_batch
from lmnet_tpu_torch.parallel.mesh import shard_context, shard_rows, sum_group


def cosine_epoch_schedule(
    base_lr: float, epochs: int, steps_per_epoch: int, eta_min: float = 1e-6
) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR(T_max=epochs, eta_min)`` stepped once per
    epoch (constant within an epoch), as a function of the global step."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    base_lr: float = 1e-3,
    weight_decay: float = 1e-4,
    epochs: int = 200,
    steps_per_epoch: int = 1,
    eta_min: float = 1e-6,
) -> tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW with the reference's hyperparameters over every parameter (no
    bias/norm masking), and its schedule. ``train_step`` sets the learning
    rate from the schedule at the step count before the update, as optax
    does."""
    sched = cosine_epoch_schedule(base_lr, epochs, steps_per_epoch, eta_min)
    opt = torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, sched


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimiser and schedule, the global step count, and the generator the
    dropout masks are drawn from (on the model's device)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int
    generator: torch.Generator


def create_train_state(
    model: torch.nn.Module,
    input_shape: Sequence[int],
    seed: int = 0,
    device: torch.device | str = "cuda",
    **tx_kwargs,
) -> TrainState:
    """Move ``model`` (already initialised from its own generator) to
    ``device`` (the card unless the caller asks for the CPU) and build its
    optimiser
    (``make_optimizer(**tx_kwargs)``) and a dropout generator seeded with
    ``seed``. ``input_shape`` is the NHWC batch shape the model will train
    on: 3 channels, H and W multiples of 16 (four stride-2 stages)."""
    if len(input_shape) != 4 or input_shape[-1] != 3:
        raise ValueError(f"input_shape must be NHWC with 3 channels, got {tuple(input_shape)}")
    if input_shape[1] % 16 or input_shape[2] % 16:
        raise ValueError(f"H and W must be multiples of 16, got {tuple(input_shape)}")
    device = torch.device(device)
    model.to(device)
    optimizer, schedule = make_optimizer(model.parameters(), **tx_kwargs)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer, schedule, 0, generator)


def _weights(weight, num_classes: int):
    # the reference hard-codes CE/Dice weight [1, 4] (2 classes); multiclass
    # runs fall back to uniform weights
    if weight is not None and len(weight) != num_classes:
        return (1.0,) * num_classes
    return weight


def train_step(
    state: TrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    cm: torch.Tensor,
    num_classes: int = 2,
    ce_weight: tuple | None = (1.0, 4.0),
    dice_weight: tuple | None = (1.0, 4.0),
    label_smoothing: float = 0.001,
    mesh=None,
    global_rows: int | None = None,
    spatial: bool = False,
):
    """One optimisation step on NHWC float ``images`` and (B, H, W) integer
    ``labels``. Updates ``state`` in place; returns (state, loss, cm) with
    the loss a detached device scalar and ``cm`` plus the confusion matrix
    of this batch's train-mode predictions.

    ``mesh`` (``parallel.make_mesh``): ``images`` and ``labels`` are this
    rank's rows (``parallel/mesh.py::shard_rows``) of a global batch of
    ``global_rows`` rows (default: this rank's rows times the data axis);
    with ``spatial``, of those rows this rank's block of H rows
    (``parallel/mesh.py::h_rows``, of a global H = H x the 'spatial'
    axis, which ``shards_h`` must allow), else whole images. The loss
    returned is the global batch's, equal on every rank; ``cm`` gains this
    rank's pixels only (``train_one_epoch`` sums it over the ranks once an
    epoch)."""
    ce_weight = _weights(ce_weight, num_classes)
    dice_weight = _weights(dice_weight, num_classes)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    context = contextlib.ExitStack()
    if mesh is not None:
        n = images.shape[0] * mesh.size(0) if global_rows is None else global_rows
        rows = shard_rows(mesh, n)
        if images.shape[0] != rows.stop - rows.start or images.shape[0] == 0:
            raise ValueError(f"a rank's batch of {images.shape[0]} rows is not its share "
                             f"{rows} of a global batch of {n} over {mesh.size(0)} ranks (each "
                             "rank needs at least one row)")
        sharded = spatial and mesh.size(1) > 1
        if sharded and images.shape[1] % 16:
            raise ValueError(f"a block of {images.shape[1]} rows: H must divide by 16 x the "
                             f"{mesh.size(1)}-rank 'spatial' axis (parallel/mesh.py::shards_h)")
        context.enter_context(global_batch(sum_group(mesh, sharded), n, rows.start))
        context.enter_context(shard_context(mesh, sharded))
    with context:
        logits = state.model(images, train=True, generator=state.generator)
        loss = cross_entropy_loss(logits, labels, ce_weight, label_smoothing) + dice_loss(
            logits, labels, dice_weight
        )
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if mesh is not None:
        all_reduce_grads(state.model.parameters(), dist.group.WORLD)
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        cm = cm + confusion_matrix(logits.argmax(dim=-1), labels, num_classes)
    return state, loss.detach(), cm


@torch.no_grad()
def eval_step(
    state: TrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    cm: torch.Tensor,
    num_classes: int = 2,
    ce_weight: tuple | None = (1.0, 4.0),
    label_smoothing: float = 0.001,
):
    """One eval step (CE loss only, as the reference's evaluate). Returns
    (the batch's CE terms, updated confusion matrix, argmax predictions),
    all on the device. The terms are the (numerator, denominator) of
    ``cross_entropy_terms`` as one (2,) tensor: the batch's loss is their
    ratio, and ranks holding rows of one batch sum them before dividing
    (``parallel/mesh.py::eval_totals``)."""
    ce_weight = _weights(ce_weight, num_classes)
    logits = state.model(images, train=False)
    terms = torch.stack(cross_entropy_terms(logits, labels, ce_weight, label_smoothing))
    preds = logits.argmax(dim=-1)
    return terms, cm + confusion_matrix(preds, labels, num_classes), preds
