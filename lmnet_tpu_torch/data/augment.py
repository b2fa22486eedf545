"""Evaluation-side image preprocessing, as torch ops on the batch's device.

Counterpart of ``lmnet_tpu/data/augment.py``'s ``normalize`` and
``eval_pipeline``; the train augmentations are not ported yet.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """A.Normalize(): x/255, subtract the ImageNet mean, divide by the std
    (float32, channels last)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) / 255.0 - mean) / std


def eval_pipeline(images: torch.Tensor, masks: torch.Tensor, out_size: int = 256):
    """Val/test path: the host has already resized to ``out_size``; this
    normalizes the (B, H, W, 3) uint8 images and turns the (B, H, W) masks
    into int64 class ids."""
    return normalize(images), masks.to(torch.int64)
