"""2x bilinear upsample (align_corners=True) on NHWC tensors through the
kernel B7.

Counterpart of ``lmnet_tpu/ops/pallas/upsample_flat.py`` (``upsample2x_flat``,
selected in JAX by ``LMNET_UPSAMPLE_BACKEND=flat``; here through
``ops/resize.py``). On CUDA tensors it is a ``torch.autograd.Function``: the
forward launches the hand-written kernel ``csrc/upsample_flat.cu`` (built by
``ops/_build.py``; a failed build or launch raises); the backward is the
exact adjoint, autograd of the plain lerp in float32, as JAX's is the
transposed lerp matrices in float32. On CPU tensors it is
``upsample2x_flat_plain``. Unlike the TPU kernel it takes every H, W >= 1
(JAX sends H % 8 != 0 or W*C % 128 != 0 to its einsum path).
"""

from __future__ import annotations

import ctypes

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = _build.load("upsample_flat").lmnet_upsample2x
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _lerp2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The 2x align_corners=True lerp of float32 ``x`` along ``axis``: even
    output 2k = x[k] + a_k (x[k-1] - x[k]), a_k = k / (2S-1); odd 2k+1 =
    x[k] + b_k (x[k+1] - x[k]), b_k = (S-1-k) / (2S-1); the clamped border
    neighbour has weight 0."""
    S = x.shape[axis]
    k = torch.arange(S, device=x.device, dtype=torch.float32)
    shape = [1] * x.dim()
    shape[axis] = S
    a = (k / (2 * S - 1)).reshape(shape)
    b = ((S - 1 - k) / (2 * S - 1)).reshape(shape)
    idx = torch.arange(S, device=x.device)
    xm1 = x.index_select(axis, (idx - 1).clamp_min(0))
    xp1 = x.index_select(axis, (idx + 1).clamp_max(S - 1))
    even = x + a * (xm1 - x)
    odd = x + b * (xp1 - x)
    out = torch.stack([even, odd], dim=axis + 1)
    return out.reshape(*x.shape[:axis], 2 * S, *x.shape[axis + 1:])


def upsample2x_flat_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the phase lerp along H, then along W, in
    float32, rounded once to x's dtype."""
    return _lerp2x(_lerp2x(x.float(), 1), 2).to(x.dtype)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"upsample2x_flat takes float32 or bfloat16, not {x.dtype}")
    B, H, W, C = x.shape
    out = torch.empty(B, 2 * H, 2 * W, C, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), out.data_ptr(), B, H, W, C, _DTYPE_CODE[x.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_flat launch failed: CUDA error {err}")
    upsample2x_flat.launches += 1
    return out


class _Upsample2xFlat(torch.autograd.Function):
    """The B7 forward; the backward is the float32 adjoint of the lerp."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return _launch(x)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            x = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device, requires_grad=True)
            out = _lerp2x(_lerp2x(x, 1), 2)
            (gx,) = torch.autograd.grad(out, x, g.float())
        return gx.to(ctx.dtype)


def upsample2x_flat(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)`` on
    NHWC (B, H, W, C) ``x`` -> (B, 2H, 2W, C) in x's dtype, float32 math;
    differentiable. On a CUDA tensor a permuted view, or one whose data
    does not start on 16 bytes, is copied to a contiguous one first; each
    launch of the kernel adds one to ``upsample2x_flat.launches``."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return upsample2x_flat_plain(x)
    return _Upsample2xFlat.apply(aligned(x.contiguous()))


upsample2x_flat.launches = 0
