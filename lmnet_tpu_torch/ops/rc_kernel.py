"""The deploy-mode ReparamConv block in two fused passes.

Counterpart of ``lmnet_tpu/ops/pallas/rc_kernel.py`` (``fused_reparam_conv``,
``fold_rc_weights``, ``_rc_xla``). The block is

    e = hardswish(We x + be)                      (expand, BN folded in)
    t = gelu_tanh(dw5x5(e) + bdw)
    s = hardsigmoid(fc2(relu(fc1(mean_hw(t)))))   (squeeze-excitation)
    y = Wp (t * s) + bp + Wsc x + bsc

On CUDA tensors ``fused_reparam_conv`` launches ``csrc/rc_fused.cu`` twice:
phase 1 computes t in the kernel and returns only its per-image channel sums
(B, E); the SE MLP runs here in float32 on them; phase 2 recomputes t, scales
it and computes both 1x1 products and the residual in the kernel body. A
failed build or launch raises. On CPU tensors it is
``fused_reparam_conv_plain``. JAX sends maps under 8x8 to XLA; the CUDA
kernel takes every H, W >= 1.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.rc_flat import (
    BN_EPS,
    _DTYPE_CODE,
    check_cuda,
    fold_rc_flat_weights,
    se_scale,
)


def _kernels():
    lib = _build.load("rc_fused")
    p1, p2, ws = lib.lmnet_rc_fused_phase1, lib.lmnet_rc_fused_phase2, lib.lmnet_rc_fused_workspace
    if p1.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        p1.argtypes = [p] * 7 + [i] * 6 + [p]
        p1.restype = ctypes.c_int
        p2.argtypes = [p] * 11 + [i] * 7 + [p]
        p2.restype = ctypes.c_int
        ws.argtypes = [i] * 6
        ws.restype = ctypes.c_longlong
    return p1, p2, ws


def fold_rc_weights(sd: Mapping[str, torch.Tensor], name: str, eps: float = BN_EPS) -> dict:
    """The deploy block ``name`` of a ``structural_reparam`` state dict as the
    kernel's float32 weights, in JAX's ``fold_rc_weights`` layout:
    ``fold_rc_flat_weights`` with the depthwise kernel as kdw (25, E),
    row-major taps, in place of kd."""
    w = fold_rc_flat_weights(sd, name, eps)
    kd = w.pop("kd")
    w["kdw"] = kd.reshape(kd.shape[0], 25).t()
    return w


def fused_reparam_conv(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The deploy ReparamConv block: NHWC (B, H, W, Cin) ``x`` -> (B, H, W,
    Cout) in x's dtype, with ``w`` from ``fold_rc_weights``; float32 math.

    On CUDA tensors it runs the two kernel phases (x is made contiguous
    first, a copy where it is a permuted view) and adds one to
    ``fused_reparam_conv.launches`` per call; on CPU tensors it is
    ``fused_reparam_conv_plain``.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_reparam_conv_plain(x, w)
    B, H, W, Cin = x.shape
    E, Cout = w["we"].shape[0], w["wp"].shape[0]
    if tuple(w["we"].shape) != (E, Cin) or tuple(w["kdw"].shape) != (25, E):
        raise ValueError(f"weights do not fit x with {Cin} channels: we {tuple(w['we'].shape)}, "
                         f"kdw {tuple(w['kdw'].shape)}")
    x = x.contiguous()
    # the kernel's layouts: contiguous along the channel the threads walk
    weT, wpT, wscT = (w[k].float().t().contiguous() for k in ("we", "wp", "wsc"))
    be, kdw, bdw, bp, bsc = (w[k].float().contiguous() for k in ("be", "kdw", "bdw", "bp", "bsc"))
    check_cuda("fused_reparam_conv", x, weT, wpT, wscT, be, kdw, bdw, bp, bsc)
    phase1, phase2, ws = _kernels()
    n_part = ws(B, H, W, Cin, E, Cout)
    if n_part < 0:
        raise ValueError(f"rc_fused does not take B={B} H={H} W={W} Cin={Cin} E={E} Cout={Cout}")
    f32 = dict(dtype=torch.float32, device=x.device)
    sums = torch.empty(B, E, **f32)
    part = torch.empty(n_part, **f32)
    dtype = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = phase1(x.data_ptr(), weT.data_ptr(), be.data_ptr(), kdw.data_ptr(), bdw.data_ptr(),
                     sums.data_ptr(), part.data_ptr(), B, H, W, Cin, E, dtype, stream)
        if err != 0:
            raise RuntimeError(f"rc_fused phase 1 launch failed: CUDA error {err}")
        s = se_scale(sums, w, H * W).contiguous()
        out = torch.empty(B, H, W, Cout, dtype=x.dtype, device=x.device)
        err = phase2(x.data_ptr(), s.data_ptr(), weT.data_ptr(), be.data_ptr(), kdw.data_ptr(),
                     bdw.data_ptr(), wpT.data_ptr(), bp.data_ptr(), wscT.data_ptr(),
                     bsc.data_ptr(), out.data_ptr(), B, H, W, Cin, E, Cout, dtype, stream)
    if err != 0:
        raise RuntimeError(f"rc_fused phase 2 launch failed: CUDA error {err}")
    fused_reparam_conv.launches += 1
    return out


def fused_reparam_conv_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The plain version (JAX's ``_rc_xla``): float32 throughout, cast to
    x's dtype at the end."""
    E = w["we"].shape[0]
    xf = x.float()
    e = F.hardswish(F.linear(xf, w["we"].float(), w["be"].float()))
    kd = w["kdw"].float().t().reshape(E, 1, 5, 5)
    t = F.gelu(F.conv2d(e.permute(0, 3, 1, 2), kd, w["bdw"].float(), padding=2, groups=E),
               approximate="tanh")
    s = se_scale(t.sum(dim=(2, 3)), w, t.shape[2] * t.shape[3])
    t = (t * s[:, :, None, None]).permute(0, 2, 3, 1)
    y = (F.linear(t, w["wp"].float(), w["bp"].float())
         + F.linear(xf, w["wsc"].float(), w["bsc"].float()))
    return y.to(x.dtype)


fused_reparam_conv.launches = 0
