"""Resampling ops with PyTorch numerics on NHWC tensors.

Counterpart of ``lmnet_tpu/ops/resize.py``. The reference decoder upsamples
with ``nn.Upsample(mode='bilinear', align_corners=True)`` and the bottleneck
pools with ``adaptive_avg_pool2d``; here those are the torch ops themselves,
applied to an NCHW view of the NHWC tensor (a permute, no copy).

Every 2x upsample of the model and the deploy graph goes through
``upsample2x_align_corners``, which dispatches on ``UPSAMPLE_BACKEND``, read
once at import from ``LMNET_UPSAMPLE_BACKEND`` as in JAX: 'einsum' (the
default; JAX's name, here ``F.interpolate``) or 'flat' (the B7 kernel,
``ops/upsample_flat.py``). Set the attribute to switch within a process. An
unknown value raises (JAX quietly takes 'einsum').
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat

UPSAMPLE_BACKENDS = ("einsum", "flat")
UPSAMPLE_BACKEND = os.environ.get("LMNET_UPSAMPLE_BACKEND", "einsum")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def bilinear_resize(
    x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``out_hw``, as
    ``F.interpolate(mode='bilinear', align_corners=...)``."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=align_corners)
    return _nhwc(y)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``,
    through the backend ``UPSAMPLE_BACKEND`` names."""
    if UPSAMPLE_BACKEND == "flat":
        return upsample2x_flat(x)
    if UPSAMPLE_BACKEND != "einsum":
        raise ValueError(f"LMNET_UPSAMPLE_BACKEND must be one of {UPSAMPLE_BACKENDS}, "
                         f"not {UPSAMPLE_BACKEND!r}")
    _, h, w, _ = x.shape
    return bilinear_resize(x, (2 * h, 2 * w), align_corners=True)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` on NHWC ``x`` (torch's floor/ceil regions)."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)))


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """``AdaptiveAvgPool2d(1)`` on NHWC ``x`` (used by SE)."""
    return x.mean(dim=(1, 2), keepdim=keepdims)
