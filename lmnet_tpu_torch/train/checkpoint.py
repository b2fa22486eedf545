"""Checkpoint and resume with the reference's four-field contract.

Counterpart of ``lmnet_tpu/train/checkpoint.py`` (Orbax there, ``torch.save``
here). Reference contract (``train.py:176-181, 225-241``): every epoch save
``{epoch, state_dict, optimizer, lr_schedule}`` to
``{model}{dataset}_{fold}_checkpoint`` (rolling) plus a best-val-IoU copy
``...best_{fold}``; resume restores all four and continues at epoch + 1.

The payload holds ``epoch``, ``best_iou`` (the best-val-IoU watermark, so a
resume cannot regress the best checkpoint), ``step``, ``model`` (the model's
``state_dict``: parameters and BatchNorm running statistics) and
``optimizer`` (AdamW's ``state_dict``: its moments and step counts). The
learning rate is a pure function of ``step`` (the per-epoch cosine), so
restoring the step restores it. Each checkpoint is one file named as JAX
names its directory; a save writes a temporary file and renames it, so a
checkpoint on disk is always whole.

Under a process group (``parallel.dist_utils``) every rank calls
``save_checkpoint``: rank 0 writes (the ranks' states are equal), then all
wait at a barrier, so a rank that loads next finds the file whole. Every
rank loads for itself (JAX's CLI gates its writes on ``is_main_process``,
``lmnet_tpu/cli/train.py:237, 377, 413, 431``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from lmnet_tpu_torch.parallel.dist_utils import get_world_size, is_main_process
from lmnet_tpu_torch.train.engine import TrainState


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, name))


def save_checkpoint(
    ckpt_dir: str,
    name: str,
    state: TrainState,
    epoch: int,
    best_iou: float = 0.0,
) -> None:
    """Save a rolling checkpoint (overwrites the previous one of this name),
    atomically; under a process group, rank 0 writes and every rank waits
    for it."""
    if is_main_process():
        _write(ckpt_dir, name, state, epoch, best_iou)
    if get_world_size() > 1:
        dist.barrier()


def _write(ckpt_dir: str, name: str, state: TrainState, epoch: int, best_iou: float) -> None:
    path = _path(ckpt_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_iou": float(best_iou),
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(ckpt_dir: str, name: str, state: TrainState):
    """Load a checkpoint into ``state`` (in place, on the state's device).
    Returns ``(state, epoch, best_iou)``."""
    device = next(state.model.parameters()).device
    payload = torch.load(_path(ckpt_dir, name), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), float(payload["best_iou"])


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.isfile(_path(ckpt_dir, name))
