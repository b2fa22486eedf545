"""Neighborhood attention (k=3) on NHWC tensors through the tiled kernel B3.

Counterpart of ``lmnet_tpu/ops/pallas/nat_kernel.py``
(``neighborhood_attention_pallas``, JAX's ``nat_backend='pallas'``). On CUDA
tensors it is a ``torch.autograd.Function``: the forward launches the
hand-written kernel ``csrc/nat_kernel.cu`` (built by ``ops/_build.py``; a
failed build or launch raises) and saves q, k, v and rpb; the backward
recomputes the plain NAT (``ops/nat.py``) and differentiates it, as JAX's
``custom_vjp`` takes the XLA vjp. On CPU tensors it is the plain NAT, which
autograd differentiates. Unlike the TPU kernel, the CUDA kernel takes every
H, W >= 3 and any head_dim.
"""

from __future__ import annotations

import ctypes

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = _build.load("nat_kernel")
    fn, takes = lib.lmnet_nat_tile, lib.lmnet_nat_tile_takes
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        takes.argtypes = [i]
        takes.restype = ctypes.c_int
    return fn, takes


def _check(q, k, v, rpb, kernel_size: int) -> tuple[int, int]:
    """Validate shapes; returns (heads, head_dim)."""
    if kernel_size != 3:
        raise ValueError(f"the B3 kernel takes kernel_size 3 (the model's), not {kernel_size}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one NHWC shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    heads = rpb.shape[0]
    if tuple(rpb.shape) != (heads, 5, 5) or q.shape[-1] % heads:
        raise ValueError(f"rpb {tuple(rpb.shape)} does not fit C={q.shape[-1]}")
    return heads, q.shape[-1] // heads


def _launch(q, k, v, rpb, heads: int, hd: int) -> torch.Tensor:
    B, H, W, C = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the B3 kernel takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if rpb.dtype != torch.float32 or rpb.device != q.device:
        raise ValueError("rpb must be float32 on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("rpb", rpb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H < 3 or W < 3:
        raise ValueError(f"feature map {H}x{W} smaller than the 3x3 window")
    fn, takes = _kernel()
    if not takes(C):
        raise ValueError(f"the B3 kernel's halo of C={C} channels does not fit shared memory")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(),
                 B, H, W, heads, hd, float(hd) ** -0.5, _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nat_kernel launch failed: CUDA error {err}")
    neighborhood_attention_pallas.launches += 1
    return out


class _NatPallas(torch.autograd.Function):
    """The B3 forward; the backward is autograd of the plain NAT."""

    @staticmethod
    def forward(ctx, q, k, v, rpb, heads, hd):
        ctx.save_for_backward(q, k, v, rpb)
        return _launch(q, k, v, rpb, heads, hd)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            prim = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = neighborhood_attention(*prim, 3)
            grads = torch.autograd.grad(out, prim, g)
        return (*grads, None, None)


def neighborhood_attention_pallas(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    kernel_size: int = 3,
) -> torch.Tensor:
    """NAT (k=3, NATTEN semantics, scale head_dim ** -0.5) on NHWC (B, H, W, C)
    q, k, v with the (heads, 5, 5) float32 bias ``rpb``; differentiable.
    Returns (B, H, W, C) in q's dtype. Each launch of the CUDA forward adds
    one to ``neighborhood_attention_pallas.launches``."""
    heads, hd = _check(q, k, v, rpb, kernel_size)
    if q.device.type == "cpu":
        return neighborhood_attention_pallas_plain(q, k, v, rpb)
    return _NatPallas.apply(q, k, v, rpb, heads, hd)


def neighborhood_attention_pallas_plain(q, k, v, rpb) -> torch.Tensor:
    """The plain PyTorch version: ``ops/nat.py::neighborhood_attention``."""
    return neighborhood_attention(q, k, v, rpb, 3)


neighborhood_attention_pallas.launches = 0
