"""Neighborhood attention (k=3) on flat ``(B, H, W*C)`` activations, with its
gradient.

Counterpart of ``lmnet_tpu/ops/pallas/nat_flat.py`` (``nat_flat`` and its
``custom_vjp`` backward ``nat_flat_bwd``). On CUDA tensors ``nat_flat`` is a
``torch.autograd.Function``: its forward launches the hand-written kernel
``csrc/nat_fwd.cu`` and saves only q, k, v and rpb, as JAX's ``custom_vjp``
saves the primals; its backward launches ``csrc/nat_bwd.cu``, which
recomputes the softmax. Both are built by ``ops/_build.py``; a failed build
or launch raises. On CPU tensors ``nat_flat`` runs the plain version,
``ops/nat.py::neighborhood_attention``, and autograd differentiates it.
``nat_flat_bwd_plain`` is the plain backward the kernel is held against.
Unlike the TPU kernels, the CUDA kernels take every shape with H, W >= 3:
any head_dim, any row count, any width.
"""

from __future__ import annotations

import ctypes

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_kernel():
    fn = _build.load("nat_fwd").lmnet_nat_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    lib = _build.load("nat_bwd")
    fn, ws = lib.lmnet_nat_bwd, lib.lmnet_nat_bwd_workspace
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 12 + [i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        ws.argtypes = [i, i, i, i, i]
        ws.restype = ctypes.c_longlong
    return fn, ws


def _check_shapes(q, k, v, rpb, heads: int, C: int, W: int) -> tuple[int, int, int]:
    """Validate the flat layout; returns (B, H, head_dim)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W*C), got {tuple(q.shape)}")
    B, H, WC = q.shape
    if WC != W * C or C % heads:
        raise ValueError(f"W*C={W}*{C} vs {WC}, heads={heads}: inconsistent")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if tuple(rpb.shape) != (heads, 5, 5):
        raise ValueError(f"rpb must be ({heads}, 5, 5), got {tuple(rpb.shape)}")
    return B, H, C // heads


def _check_cuda(q, rpb, H: int, W: int, heads: int, **others) -> None:
    """What the CUDA kernels take: float32 or bfloat16 activations of one
    dtype and device, float32 rpb, contiguous, H and W >= 3."""
    if q.device.type != "cuda":
        raise ValueError(f"nat_flat runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"nat_flat takes float32 or bfloat16, not {q.dtype}")
    for name, t in others.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if rpb.dtype != torch.float32 or rpb.device != q.device:
        raise ValueError("rpb must be float32 on q's device")
    if H < 3 or W < 3:
        raise ValueError(f"feature map {H}x{W} smaller than the 3x3 window")
    for name, t in (("q", q), ("rpb", rpb), *others.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_fwd(q, k, v, rpb, heads: int, C: int, W: int, scale: float) -> torch.Tensor:
    B, H, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(),
            B, H, W, heads, C // heads, scale, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nat_fwd launch failed: CUDA error {err}")
    nat_flat.launches += 1
    return out


def _launch_bwd(q, k, v, rpb, g, heads: int, C: int, W: int, scale: float):
    B, H, _ = q.shape
    hd = C // heads
    fn, ws = _bwd_kernel()
    n_part = ws(B, H, W, heads, hd)
    if n_part < 0:  # nat_bwd.cu takes at most 256 heads (one query block's threads)
        raise ValueError(f"nat_bwd does not take B={B} H={H} W={W} heads={heads} hd={hd}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drpb = torch.empty_like(rpb)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty(B * H * W * heads, **f32)
    delta = torch.empty(B * H * W * heads, **f32)
    part = torch.empty(n_part, **f32)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), rpb.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drpb.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), part.data_ptr(),
            B, H, W, heads, hd, scale, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nat_bwd launch failed: CUDA error {err}")
    nat_flat_bwd.launches += 1
    return dq, dk, dv, drpb


class _NatFlat(torch.autograd.Function):
    """The CUDA forward, and the CUDA backward from the saved primals."""

    @staticmethod
    def forward(ctx, q, k, v, rpb, heads, C, W, scale):
        ctx.save_for_backward(q, k, v, rpb)
        ctx.config = (heads, C, W, scale)
        return _launch_fwd(q, k, v, rpb, heads, C, W, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rpb = ctx.saved_tensors
        grads = nat_flat_bwd(q, k, v, rpb, g.contiguous(), *ctx.config)
        return (*grads, None, None, None, None)


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
    """NAT (k=3, NATTEN semantics) on flat (B, H, W*C) q, k, v; differentiable.

    ``rpb`` is the (heads, 5, 5) float32 bias; ``scale`` defaults to
    head_dim ** -0.5. Returns (B, H, W*C) in q's dtype. Each launch of the
    CUDA forward adds one to ``nat_flat.launches``; its backward counts in
    ``nat_flat_bwd.launches``.
    """
    B, H, hd = _check_shapes(q, k, v, rpb, heads, C, W)
    scale = float(hd) ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out = neighborhood_attention(
            q.reshape(B, H, W, C), k.reshape(B, H, W, C), v.reshape(B, H, W, C),
            rpb, 3, scale=scale,
        )
        return out.reshape(B, H, W * C)
    _check_cuda(q, rpb, H, W, heads, k=k, v=v)
    return _NatFlat.apply(q, k, v, rpb, heads, C, W, scale)


def nat_flat_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    C: int,
    W: int,
    scale: float,
):
    """Gradient of ``nat_flat`` at (q, k, v, rpb) for the output cotangent
    ``g``: returns (dq, dk, dv, d_rpb), dq/dk/dv in q's dtype, d_rpb float32.

    On CUDA tensors it launches ``csrc/nat_bwd.cu`` (one more in
    ``nat_flat_bwd.launches``); two calls with the same inputs give bitwise
    equal results. On CPU tensors it is ``nat_flat_bwd_plain``.
    """
    B, H, _ = _check_shapes(q, k, v, rpb, heads, C, W)
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {tuple(q.shape)}, got {tuple(g.shape)}")
    if q.device.type == "cpu":
        return nat_flat_bwd_plain(q, k, v, rpb, g, heads, C, W, scale)
    _check_cuda(q, rpb, H, W, heads, k=k, v=v, g=g)
    return _launch_bwd(q, k, v, rpb, g, heads, C, W, float(scale))


def nat_flat_bwd_plain(q, k, v, rpb, g, heads: int, C: int, W: int, scale: float):
    """The plain PyTorch backward: ``torch.autograd.grad`` of
    ``ops/nat.py::neighborhood_attention`` at (q, k, v, rpb) for cotangent
    ``g``. Returns (dq, dk, dv, d_rpb) in the dtypes of q, k, v and rpb."""
    B, H, _ = _check_shapes(q, k, v, rpb, heads, C, W)
    with torch.enable_grad():
        prim = [t.detach().requires_grad_() for t in (q, k, v, rpb)]
        out = neighborhood_attention(
            *(t.reshape(B, H, W, C) for t in prim[:3]), prim[3], 3, scale=scale
        )
        return torch.autograd.grad(out.reshape(B, H, W * C), prim, g)


nat_flat.launches = 0
nat_flat_bwd.launches = 0
