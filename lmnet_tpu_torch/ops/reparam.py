"""Structural re-parameterization math: fuse the multi-branch depthwise
training graph into one large depthwise kernel for deployment.

Counterpart of ``lmnet_tpu/ops/reparam.py``, on PyTorch OIHW depthwise
kernels (shape ``(C, 1, kh, kw)``) instead of JAX's HWIO ``(kh, kw, 1, C)``.

Each branch is ``BN(dwconv(x))``; inference-mode BN is a per-channel affine
map, so it folds into the conv as ``kernel * gamma/std`` and
``bias = beta - mean * gamma/std``. Parallel branches of different shapes
sum after the small kernels are embedded in the centre of the large one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fuse_bn(
    kernel: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold inference-mode BatchNorm into an OIHW kernel (per out channel).

    Returns (fused_kernel, fused_bias).
    """
    t = gamma / torch.sqrt(var + eps)
    return kernel * t.reshape(-1, 1, 1, 1), beta - mean * t


def embed_kernel(small: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Zero-embed a small OIHW kernel in the centre of a (kh, kw) one."""
    sh, sw = small.shape[2], small.shape[3]
    ph, pw = (kh - sh) // 2, (kw - sw) // 2
    return F.pad(small, (pw, kw - sw - pw, ph, kh - sh - ph))


def merge_branches(
    kernels_and_biases: list[tuple[torch.Tensor, torch.Tensor]],
    large_kernel_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum BN-fused parallel depthwise branches into one large kernel+bias."""
    kk = large_kernel_size
    kernel = None
    bias = None
    for k, b in kernels_and_biases:
        e = embed_kernel(k, kk, kk)
        kernel = e if kernel is None else kernel + e
        bias = b if bias is None else bias + b
    return kernel, bias


def fuse_reparam_branches(
    branches: dict, large_kernel_size: int = 5, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse a ReparamConv's four train-time branches into a deploy kernel+bias.

    ``branches`` maps the branch name ('large'|'square'|'ver'|'hor') to a
    dict with 'kernel' (OIHW depthwise) and the BN terms 'scale', 'bias',
    'mean', 'var'.
    """
    fused = [
        fuse_bn(b["kernel"], b["scale"], b["bias"], b["mean"], b["var"], eps)
        for b in (branches[n] for n in ("large", "square", "ver", "hor"))
    ]
    return merge_branches(fused, large_kernel_size)
