"""Neighborhood attention (k=3) on flat ``(B, H, W*C)`` activations.

Counterpart of ``lmnet_tpu/ops/pallas/nat_flat.py::nat_flat``. On a CUDA
tensor it launches the hand-written kernel ``csrc/nat_fwd.cu`` (built by
``ops/_build.py``) or raises; on a CPU tensor it runs the plain version,
``ops/nat.py::neighborhood_attention``. Unlike the TPU kernel, the CUDA
kernel takes every shape with H, W >= 3: any head_dim, any row count.
"""

from __future__ import annotations

import ctypes

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = _build.load("nat_fwd").lmnet_nat_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def nat_flat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    heads: int,
    C: int,
    W: int,
    scale: float | None = None,
) -> torch.Tensor:
    """NAT (k=3, NATTEN semantics) on flat (B, H, W*C) q, k, v.

    ``rpb`` is the (heads, 5, 5) float32 bias; ``scale`` defaults to
    head_dim ** -0.5. Returns (B, H, W*C) in q's dtype. Each launch of the
    CUDA kernel adds one to ``nat_flat.launches``.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W*C), got {tuple(q.shape)}")
    B, H, WC = q.shape
    if WC != W * C or C % heads:
        raise ValueError(f"W*C={W}*{C} vs {WC}, heads={heads}: inconsistent")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if tuple(rpb.shape) != (heads, 5, 5):
        raise ValueError(f"rpb must be ({heads}, 5, 5), got {tuple(rpb.shape)}")
    hd = C // heads
    if scale is None:
        scale = float(hd) ** -0.5

    if q.device.type == "cpu":
        out = neighborhood_attention(
            q.reshape(B, H, W, C), k.reshape(B, H, W, C), v.reshape(B, H, W, C),
            rpb, 3, scale=scale,
        )
        return out.reshape(B, H, WC)

    if q.device.type != "cuda":
        raise ValueError(f"nat_flat runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"nat_flat takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if rpb.dtype != torch.float32 or rpb.device != q.device:
        raise ValueError("rpb must be float32 on q's device")
    if H < 3 or W < 3:
        raise ValueError(f"feature map {H}x{W} smaller than the 3x3 window")
    for name, t in (("q", q), ("k", k), ("v", v), ("rpb", rpb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(),
            B, H, W, heads, hd, float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nat_fwd launch failed: CUDA error {err}")
    nat_flat.launches += 1
    return out


nat_flat.launches = 0
