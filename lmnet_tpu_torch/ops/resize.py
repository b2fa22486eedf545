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

Inside a shard of the mesh's 'spatial' axis (``parallel/batch.py::shard``)
'einsum' upsamples this rank's block of rows in global coordinates: each
output row's two source rows and weight come from the global H, read from
the block with one row of each neighbour; W goes through ``F.interpolate``.
'flat' runs B7 there on the same slab, in global coordinates
(``ops/upsample_flat.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat
from lmnet_tpu_torch.parallel.batch import current_shard
from lmnet_tpu_torch.parallel.spatial import halo

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
    if current_shard() is not None:
        return _upsample2x_rows(x)
    return bilinear_resize(x, (2 * h, 2 * w), align_corners=True)


def _upsample2x_rows(x: torch.Tensor) -> torch.Tensor:
    """The align_corners 2x upsample of this rank's block of rows of a map of
    global height H = h x the shard's size: output row o's source is
    s = o (H - 1) / (2H - 1) in float32 (torch's arithmetic), the lerp of rows
    floor(s) and min(floor(s) + 1, H - 1), which lie in the block or one row
    beyond it; then W by ``F.interpolate``. float32 math, one rounding."""
    s = current_shard()
    B, h, W, C = x.shape
    H, off = h * s.size, h * s.index
    scale = np.float32(H - 1) / np.float32(2 * H - 1)
    src = torch.arange(2 * off, 2 * (off + h), dtype=torch.float32) * float(scale)
    i0 = src.floor().long()
    lam = (src - i0).to(x.device)
    i1 = torch.clamp(i0 + 1, max=H - 1)
    slab = halo(x, 1, 1).float()  # slab row j is global row off - 1 + j
    rows0, rows1 = slab[:, i0 - off + 1], slab[:, i1 - off + 1]
    lam = lam[None, :, None, None]
    y = rows0 * (1 - lam) + rows1 * lam
    y = F.interpolate(y.permute(0, 3, 1, 2), size=(2 * h, 2 * W), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` on NHWC ``x`` (torch's floor/ceil regions)."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)))


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """``AdaptiveAvgPool2d(1)`` on NHWC ``x`` (used by SE)."""
    return x.mean(dim=(1, 2), keepdim=keepdims)
